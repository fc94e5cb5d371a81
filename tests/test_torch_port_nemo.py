"""NeMo FastConformer's log-mel front end on the CPU:
``api.log_mel_spectrogram_nemo`` and the plain twins (``features.nemo_prologue``,
``nemo_finish``, ``nemo_log_mel`` and the kernels' wrappers in
``ops/cuda/nemo_logmel``, which run them for a CPU tensor) against the
float64 oracle ``tests/golden/nemo_ref.py`` (NeMo's ``FilterbankFeatures``
in eval and ``normalize_batch`` with ``"per_feature"``).  The kernels
themselves run only on the card (``tests/test_torch_port_nemo_cuda.py``).

Tolerance, max|Δ| of the normalised answer: the plain path rounds the DFT
product and the mel projection in float32, and the log turns a band's
rounding into its own relative error, so a narrow band (128 mels over 257
bins puts one or two bins in each low band) whose power nearly vanishes in
a frame reads up to ~6e-5 at 128 mels and ~2e-5 at 80 on seeded noise,
divided by the band's deviation (~0.5-1.3).  The limit, 3e-4, sits three
orders under each of the five faults below (2.4e-2 and up on the same
kind of data) and under the TF32 control (~0.4)."""

import numpy as np
import pytest
import torch

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import api as PA
from mfcc_rust_tpu_torch import constants as PC
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops.cuda import nemo_logmel as nl
from tests.golden import nemo_ref

RATE, HOP = 16000, 160
TOL = 3e-4


def _audio(lengths, samples, seed, std=0.1):
    """(rows, samples) float32 noise, zeros past each row's length."""
    x = np.random.default_rng(seed).normal(0.0, std, (len(lengths), samples)).astype(np.float32)
    for r, n in enumerate(lengths):
        x[r, max(n, 0):] = 0.0
    return x


def _err(got, ref):
    assert tuple(got.shape) == tuple(ref.shape), (tuple(got.shape), tuple(ref.shape))
    return (got.double() - ref.double()).abs().max().item() if ref.numel() else 0.0


# lengths of 0, 1, 159, 160, 161 samples, a whole row and mixed ones
LENGTHS = [0, 1, 159, 160, 161, 24_000, 9_999, 17_321]


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("kind", ["list", "tensor", "numpy"])
def test_api_matches_the_float64_oracle(n_mels, kind):
    x = _audio(LENGTHS, 24_000, 51)
    lens = {"list": list(LENGTHS), "tensor": torch.tensor(LENGTHS),
            "numpy": np.array(LENGTHS)}[kind]
    got, seq = PA.log_mel_spectrogram_nemo(x, lens, n_mels=n_mels, device="cpu")
    ref, ref_seq = nemo_ref.log_mel_spectrogram(x, LENGTHS, n_mels)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == (len(LENGTHS), n_mels, 1 + 24_000 // HOP)
    assert seq.dtype == torch.int64 and torch.equal(seq, ref_seq)
    assert _err(got, ref) <= TOL, _err(got, ref)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_plain_twins_compose_to_the_api(n_mels):
    x = torch.from_numpy(_audio(LENGTHS, 24_000, 52))
    lens = torch.tensor(LENGTHS)
    cfg = PA._nemo_cfg(n_mels)
    got, seq = PA.log_mel_spectrogram_nemo(x, lens, n_mels=n_mels, device="cpu")
    whole, whole_seq = PF.nemo_log_mel(x, lens, cfg)
    assert torch.equal(got, whole) and torch.equal(seq, whole_seq)
    padded = nl.nemo_prologue(x, lens, cfg)  # the CPU wrapper runs the twin
    assert torch.equal(padded, PF.nemo_prologue(x, lens, cfg))
    power = PF.mel_spectrogram_librosa(padded, cfg.replace(center=False)).transpose(-1, -2)
    fin, fin_seq = nl.nemo_finish(power, lens, HOP)
    assert torch.equal(fin, got) and torch.equal(fin_seq, seq)


def test_feature_lengths_are_len_over_hop_plus_one():
    lens = torch.tensor([0, 1, 159, 160, 161, 319, 320, 16_000, 560_000, -3])
    want = [0, 1, 1, 2, 2, 2, 3, 101, 3501, 0]
    assert PF.nemo_feature_lengths(lens, HOP).tolist() == want
    assert nemo_ref.feature_lengths(lens).tolist() == want
    x = np.zeros((2, 3_200), np.float32)
    _, seq = P.log_mel_spectrogram_nemo(x, [3_200, 1_600], device="cpu")
    assert seq.tolist() == [21, 11]


def test_the_window_is_the_symmetric_hann_centred_in_512():
    cfg = PA._nemo_cfg(128)
    win = PC.constant_bundle(cfg)["window"]
    sym = torch.hann_window(400, periodic=False, dtype=torch.float64).numpy()
    assert win.shape == (512,) and np.abs(win[56:456] - sym).max() <= 1e-15
    assert not win[:56].any() and not win[456:].any()
    assert np.array_equal(PC.window_array("hann_sym", 400, 512), win)
    uncentred = PC.constant_bundle(cfg.replace(center=False))["window"]
    assert np.array_equal(uncentred, win)


def test_prologue_is_preemphasis_within_each_length_then_the_zero_pad():
    cfg = PA._nemo_cfg(128)
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0], [5.0, 6.0, 7.0, 8.0], [1.0, 1.0, 1.0, 1.0]])
    y = PF.nemo_prologue(x, torch.tensor([3, 9, 0]), cfg)
    assert tuple(y.shape) == (3, 4 + 512)
    assert not y[:, :256].any() and not y[:, 260:].any()
    f = torch.tensor(0.97, dtype=torch.float32)
    body = y[:, 256:260]
    assert body[0].tolist() == [1.0, (2.0 - f * 1.0).item(), (3.0 - f * 2.0).item(), 0.0]
    assert body[1, 0].item() == 5.0 and body[1, 3].item() == (8.0 - f * 7.0).item()
    assert not body[2].any()


def test_wrappers_on_the_cpu_fill_the_frame_counts_and_compute_every_frame():
    """For a CPU tensor the prologue's wrapper writes each row's frame
    count into ``used`` and returns the plain twin's whole buffer, and K2's
    wrapper takes ``used`` and still computes every frame (the plain
    version)."""
    from mfcc_rust_tpu_torch.ops.cuda import ct_mel as ck

    cfg = PA._nemo_cfg(80)
    lens = torch.tensor([0, 1, 159, 160, 161, 3_200, 9_999])
    x = torch.from_numpy(_audio(lens.tolist(), 3_200, 59))
    used = torch.full_like(lens, -7)
    y = nl.nemo_prologue(x, lens, cfg, used)
    assert used.tolist() == PF.nemo_feature_lengths(lens, HOP).tolist() == [0, 1, 1, 2, 2, 21, 63]
    assert torch.equal(y, PF.nemo_prologue(x, lens, cfg))
    cu = cfg.replace(center=False)
    assert torch.equal(ck.ct_mel(y, cu, used), ck.ct_mel(y, cu))


def test_the_direct_launcher_runs_the_plain_path_on_the_cpu():
    """``nemo_direct`` (the card's four launches for the API's direct
    path) runs the plain path for a CPU tensor, leading dimensions kept."""
    cfg = PA._nemo_cfg(80)
    lens = torch.tensor([[0, 161, 3_200], [1, 9_999, 4_000]])
    x = torch.from_numpy(_audio(lens.reshape(-1).tolist(), 9_999, 60)).reshape(2, 3, 9_999)
    got, seq = nl.nemo_direct(x, lens, cfg.replace(center=False))
    want, want_seq = PF.nemo_log_mel(x, lens, cfg)
    assert tuple(got.shape) == (2, 3, 80, 63) and torch.equal(seq, want_seq)
    assert torch.equal(got, want)


def test_rows_of_no_or_one_frame_read_zeros():
    """A row of length 0 (no frame) and rows of one frame (NeMo raises on
    the card there; its masked formula gives zeros): all zeros."""
    x = _audio([0, 1, 159, 24_000], 24_000, 53)
    got, seq = P.log_mel_spectrogram_nemo(x, [0, 1, 159, 24_000], device="cpu")
    assert seq.tolist() == [0, 1, 1, 151]
    assert not got[:3].any() and got[3].abs().max() > 1.0


def test_statistics_are_over_each_rows_own_frames():
    """Each row's mean is 0 and its unbiased deviation ~1 over its own
    frames, and every frame past them is 0."""
    lens = [24_000, 9_999, 17_321]
    x = _audio(lens, 24_000, 54)
    got, seq = P.log_mel_spectrogram_nemo(x, lens, n_mels=80, device="cpu")
    for r, n in enumerate(seq.tolist()):
        kept = got[r, :, :n].double()
        assert kept.mean(-1).abs().max() < 1e-5
        assert (kept.std(-1) - 1.0).abs().max() < 1e-4
        assert not got[r, :, n:].any()


def test_silence_and_a_length_past_the_row():
    """A silent row is 0 everywhere (its logs are all the guard's, the mean
    exact); a length past the row takes every frame there is and returns
    NeMo's count."""
    x = _audio([24_000, 24_000], 24_000, 55)
    x[0] = 0.0
    got, seq = P.log_mel_spectrogram_nemo(x, [24_000, 40_000], device="cpu")
    assert seq.tolist() == [151, 251]
    assert not got[0].any()
    ref, _ = nemo_ref.log_mel_spectrogram(x, [24_000, 40_000])
    assert _err(got, ref) <= TOL
    assert _err(got[1], P.log_mel_spectrogram_nemo(x[1], 24_000, device="cpu")[0]) <= 1e-5


def test_leading_dims_and_defaults():
    x = _audio([8_000] * 6, 8_000, 56).reshape(2, 3, 8_000)
    got, seq = P.log_mel_spectrogram_nemo(x, np.full((2, 3), 8_000), device="cpu")
    assert tuple(got.shape) == (2, 3, 128, 51) and tuple(seq.shape) == (2, 3)
    with pytest.raises(TypeError):  # the lengths are data: no default
        P.log_mel_spectrogram_nemo(x, device="cpu")
    one, one_seq = P.log_mel_spectrogram_nemo(x[0, 0], 8_000, device="cpu")
    assert tuple(one.shape) == (128, 51) and one_seq.item() == 51
    assert _err(one, got[0, 0]) <= 1e-5
    with pytest.raises(ValueError):
        P.log_mel_spectrogram_nemo(x, [8_000, 8_000], device="cpu")


def test_the_cpu_call_counts_an_eager_path():
    before = PA.paths.read()
    P.log_mel_spectrogram_nemo(_audio([1_600], 1_600, 57), [1_600], device="cpu")
    after = PA.paths.read()
    assert after["eager"] == before["eager"] + 1 and after["direct"] == before["direct"]


def test_gradient_flows_through_the_plain_path():
    x = torch.from_numpy(_audio([16_000, 12_000], 16_000, 58)).requires_grad_(True)
    out, _ = P.log_mel_spectrogram_nemo(x, [16_000, 12_000], n_mels=80, device="cpu")
    (out * torch.linspace(0, 1, out.shape[-1])).sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert not x.grad[1, 12_000:].any()  # no sample past a row's length is read


def _faulty(**kw):
    """NeMo's front end on the plain path with one step broken."""
    def run(x, lens, n_mels):
        cfg = PA._nemo_cfg(n_mels)
        if "cfg" in kw:
            cfg = cfg.replace(**kw["cfg"])
        lens = torch.as_tensor(lens)
        seq = PF.nemo_feature_lengths(lens, HOP)
        mel = PF.mel_spectrogram_librosa(PF.nemo_prologue(torch.from_numpy(x), lens, cfg),
                                         cfg.replace(center=False))
        if kw.get("all_frames"):
            return PF.nemo_finish(mel, torch.full_like(seq, mel.shape[-1]))
        if kw.get("unmasked"):  # each row's own statistics, every frame normalised
            log = torch.log(mel + PF.NEMO_LOG_GUARD)
            n = seq.clamp(max=mel.shape[-1])[:, None, None]
            valid = torch.arange(mel.shape[-1]) < n
            mean = torch.where(valid, log, 0.0).sum(-1, keepdim=True) / n
            var = torch.where(valid, (log - mean) ** 2, 0.0).sum(-1, keepdim=True) / (n - 1)
            return (log - mean) / (torch.sqrt(var) + PF.NEMO_STD_FLOOR)
        out = PF.nemo_finish(mel, seq)
        if kw.get("biased"):
            n = seq.clamp(max=mel.shape[-1]).double()
            return out * torch.sqrt(n / (n - 1))[:, None, None].float()
        return out
    return run


FAULTS = {"lengths_ignored": _faulty(all_frames=True), "biased_deviation": _faulty(biased=True),
          "no_preemphasis": _faulty(cfg={"preemphasis_cof": 0.0}),
          "periodic_window": _faulty(cfg={"window": "hann"}), "mask_left_out": _faulty(unmasked=True)}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_each_fault_fails_the_tolerance(fault):
    lens = [24_000, 9_999, 17_321, 16_000]
    x = _audio(lens, 24_000, 59)
    ref, _ = nemo_ref.log_mel_spectrogram(x, lens, 128)
    if fault is None:
        got = _faulty()(x, lens, 128)
        assert _err(got, ref) <= TOL
    else:
        got = FAULTS[fault](x, lens, 128)
        assert _err(got, ref) > 30 * TOL, (fault, _err(got, ref))
