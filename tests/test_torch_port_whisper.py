"""Whisper's log-mel front end on the CPU: ``api.log_mel_spectrogram_whisper``
and the plain path ``features.whisper_log_mel`` against the float64
reference ``tests/golden/whisper_ref.py`` (openai/whisper's
``log_mel_spectrogram`` with the maximum per row), and the finish kernel's
plain twin (``ops/cuda/whisper_logmel.whisper_logmel_plain``) on K2's plain
output.  The kernels themselves run only on the card
(``tests/test_torch_port_whisper_cuda.py``).

Tolerances, max|Δ| in Whisper's output units ((log10 + 4) / 4): the plain
path rounds the DFT product and the mel projection in float32, and the log
turns a band's rounding into its own relative error, so a narrow band (128
mels over 201 bins puts one or two bins in each low band) whose power nearly
vanishes in a frame reads up to ~1.4e-4 at 128 mels and ~1e-5 at 80 on
seeded noise.  The limits, 5e-4 and 5e-5, sit below the TF32 control's
3e-3 and up on the same data."""

import numpy as np
import pytest
import torch

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import api as PA
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops.cuda import ct_mel as ck
from mfcc_rust_tpu_torch.ops.cuda import whisper_logmel as wl
from tests.golden import whisper_ref

RATE, HOP = 16000, 160
TOL = {80: 5e-5, 128: 5e-4}


def _audio(rows, seconds, seed, std=0.1, speech_s=None):
    """(rows, n) float32 noise; with ``speech_s`` zeros past that many
    seconds in every row but the first."""
    n = int(round(seconds * RATE))
    x = np.random.default_rng(seed).normal(0.0, std, (rows, n)).astype(np.float32)
    if speech_s is not None:
        x[1:, int(speech_s * RATE):] = 0.0
    return x


def _cfg(n_mels):
    return P.librosa_config(RATE, 400, HOP, 400, n_mels)


def _err(got, ref):
    assert tuple(got.shape) == tuple(ref.shape), (tuple(got.shape), tuple(ref.shape))
    return (got.double() - ref.double()).abs().max().item()


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("seconds", [1.0, 7.3, 30.0])
def test_api_and_plain_path_match_the_float64_reference(n_mels, seconds):
    x = _audio(2, seconds, 11, speech_s=min(2.5, seconds / 2))
    ref = whisper_ref.log_mel_spectrogram(x, n_mels)
    got = PA.log_mel_spectrogram_whisper(x, n_mels=n_mels, device="cpu")
    plain = PF.whisper_log_mel(torch.from_numpy(x), _cfg(n_mels))
    frames = x.shape[-1] // HOP
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == (2, n_mels, frames)
    assert torch.equal(got, plain)
    assert _err(got, ref) <= TOL[n_mels], _err(got, ref)


def test_the_default_is_80_mels_and_the_mels_follow_the_argument_alone():
    x = _audio(1, 1.0, 12)[0]
    assert tuple(PA.log_mel_spectrogram_whisper(x, device="cpu").shape) == (80, 100)
    assert tuple(P.log_mel_spectrogram_whisper(x, 128, device="cpu").shape) == (128, 100)


def test_the_last_frame_is_dropped():
    """480,000 samples: K2's 3,001 centred frames, 3,000 kept; the answer is
    the finish of the first 3,000, whatever the last one holds."""
    x = torch.from_numpy(_audio(1, 30.0, 13)[0])
    cfg = _cfg(128)
    mel = PF.mel_spectrogram_librosa(x, cfg)
    assert tuple(mel.shape) == (128, 3001)
    got = PA.log_mel_spectrogram_whisper(x, n_mels=128, device="cpu")
    assert tuple(got.shape) == (128, 3000)
    loud = mel.clone()
    loud[:, -1] = 1e6  # the dropped frame would set the floor if it were read
    assert torch.equal(PF.whisper_finish(loud), got)


def test_a_zero_tail_takes_the_floor_of_its_own_row():
    x = _audio(2, 7.3, 14, speech_s=1.0)
    got = PA.log_mel_spectrogram_whisper(x, n_mels=128, device="cpu")
    ref = whisper_ref.log_mel_spectrogram(x, 128)
    assert _err(got, ref) <= TOL[128]
    # row 1: frames wholly past its first second (and the window's reach)
    # are silent, so they read the floor: 8 decades under the row's maximum
    tail = got[1, :, (RATE + 400) // HOP:]
    top = torch.log10(torch.clamp_min(PF.mel_spectrogram_librosa(
        torch.from_numpy(x[1]), _cfg(128))[:, :-1], 1e-10)).amax()
    floor = (top - 8.0 + 4.0) / 4.0
    assert tail.numel() > 0 and bool((tail == floor).all())
    assert bool((got[0] > floor - 1.0).all())


def _global_max(x, n_mels):
    """The float64 reference's steps with openai's whole-array maximum."""
    raw = torch.log10(torch.clamp(_mel_power64(x, n_mels), min=1e-10))
    return (torch.maximum(raw, raw.max() - 8.0) + 4.0) / 4.0


def _mel_power64(x, n_mels):
    audio = torch.as_tensor(x, dtype=torch.float64)
    window = torch.hann_window(400, dtype=torch.float64)
    stft = torch.stft(audio, 400, HOP, window=window, return_complex=True)
    fb = torch.as_tensor(whisper_ref.mel_filters(RATE, 400, n_mels))
    return fb @ (stft[..., :-1].abs() ** 2)


def test_each_row_of_a_batch_has_its_own_floor():
    """A loud row and a quiet one, both with zero tails: each is floored
    against its own maximum, and a maximum over the batch fails."""
    x = np.concatenate([_audio(1, 5.0, 15, std=1.0), _audio(1, 5.0, 16, std=0.03)])
    x[:, 3 * RATE:] = 0.0
    got = PA.log_mel_spectrogram_whisper(x, n_mels=80, device="cpu")
    ref = whisper_ref.log_mel_spectrogram(x, 80)
    assert _err(got, ref) <= TOL[80]
    for row in range(2):
        alone = PA.log_mel_spectrogram_whisper(x[row], n_mels=80, device="cpu")
        assert torch.equal(got[row], alone)
    floors = got.amin(dim=(-2, -1))
    assert float(floors[0] - floors[1]) > 0.5  # ~3 decades apart, / 4
    glob = _global_max(x, 80)
    assert _err(glob, ref) > 0.5
    assert _err(got, glob) > 0.5


def test_padding_appends_zeros_first():
    x = _audio(2, 2.0, 17)
    got = PA.log_mel_spectrogram_whisper(x, n_mels=80, padding=12_345, device="cpu")
    padded = np.concatenate([x, np.zeros((2, 12_345), np.float32)], axis=-1)
    assert tuple(got.shape) == (2, 80, (x.shape[-1] + 12_345) // HOP)
    assert torch.equal(got, PA.log_mel_spectrogram_whisper(padded, n_mels=80, device="cpu"))
    ref = whisper_ref.log_mel_spectrogram(x, 80, padding=12_345)
    assert _err(got, ref) <= TOL[80]


def test_batched_leading_dims_and_one_row():
    x = _audio(6, 1.5, 18).reshape(2, 3, -1)
    got = PA.log_mel_spectrogram_whisper(x, n_mels=80, device="cpu")
    assert tuple(got.shape) == (2, 3, 80, 150)
    for i in range(2):
        for j in range(3):
            one = PA.log_mel_spectrogram_whisper(x[i, j], n_mels=80, device="cpu")
            assert torch.equal(got[i, j], one)


def test_short_clips_and_gradients_take_the_plain_path():
    x = _audio(2, 0.01, 19)  # 160 samples: one kept frame; the pad folds
    got = PA.log_mel_spectrogram_whisper(x, device="cpu")
    assert tuple(got.shape) == (2, 80, 1)
    assert torch.equal(got, PF.whisper_log_mel(torch.from_numpy(x), _cfg(80)))
    empty = PA.log_mel_spectrogram_whisper(_audio(1, 0.005, 19)[0], device="cpu")
    assert tuple(empty.shape) == (80, 0)
    a = torch.from_numpy(_audio(1, 1.0, 20)).requires_grad_(True)
    PA.log_mel_spectrogram_whisper(a, device="cpu").sum().backward()
    assert a.grad is not None and bool(torch.isfinite(a.grad).all())


def test_paths_count_the_cpu_calls_as_eager():
    before = PA.paths.read()
    PA.log_mel_spectrogram_whisper(_audio(1, 1.0, 21), device="cpu")
    after = PA.paths.read()
    assert (after["eager"] - before["eager"], after["direct"] - before["direct"]) == (1, 0)


# ----------------------------------------------- the finish kernel's twin --
@pytest.mark.parametrize("n_mels", [80, 128])
def test_plain_twin_on_k2s_plain_output_matches_the_reference(n_mels):
    cfg = _cfg(n_mels)
    x = _audio(3, 4.0, 22, speech_s=1.5)
    power = ck.ct_mel_plain(torch.from_numpy(x), cfg)  # (rows, 1 + n // hop, M)
    assert tuple(power.shape) == (3, 401, n_mels)
    got = wl.whisper_logmel_plain(power)
    assert got.is_contiguous() and tuple(got.shape) == (3, n_mels, 400)
    assert _err(got, whisper_ref.log_mel_spectrogram(x, n_mels)) <= TOL[n_mels]
    assert torch.equal(got, PF.whisper_finish(power.transpose(-1, -2)))
    assert torch.equal(wl.whisper_logmel(power), got)  # a CPU tensor: the plain version


def test_plain_twin_floors_nan_and_empty_rows_as_torch_does():
    p = torch.rand(3, 6, 8) + 0.1
    p[1, 2, 3] = float("nan")
    p[2] = 0.0  # silence: log10(1e-10) everywhere, its own maximum
    got = wl.whisper_logmel_plain(p)
    assert bool(torch.isnan(got[1]).all()) and not bool(torch.isnan(got[0]).any())
    assert bool((got[2] == (-10.0 + 4.0) / 4.0).all())
    assert tuple(wl.whisper_logmel_plain(p[:, :1]).shape) == (3, 8, 0)


@pytest.mark.parametrize("kept", [1, 5, 8191, 8192, 8193, 384_000, 10**6, 10**8])
def test_the_maximum_is_split_into_parts_of_whole_float4s(kept):
    n, chunk = wl.parts(kept)
    assert 1 <= n <= wl.MAX_PARTS and chunk % 4 == 0
    assert (n - 1) * chunk < kept <= n * chunk
    assert chunk >= min(wl.PART_FLOATS, -(-kept // 4) * 4)


def test_whisper_configs_take_k2_path_3_and_the_finish():
    for n_mels in (80, 128):
        cfg = PA._whisper_cfg(n_mels)
        assert cfg == _cfg(n_mels) and PA._whisper_cfg(n_mels) is cfg
        assert ck.fft_plan(400) == (25, 1, 1) and ck.path_for(cfg) == 3
        _, _, wpack, _, kmax = ck._kernel_constants(cfg)
        assert ck.fft_warps(400, 160, kmax, wpack.size, n_mels) == 8
        assert ck.frames_per_block(400, ck._kernel_constants(cfg)[2].size) == 8
        assert wl.whisper_logmel_supported(cfg)
    assert not wl.whisper_logmel_supported(_cfg(80).replace(power=1.0))
