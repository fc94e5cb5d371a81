"""The port's ``utils.padding`` and ``utils.profiling`` on the CPU.

Padding is held to ``mfcc_rust_tpu.utils.padding`` and ``np.pad`` on the
same seeded arrays at array equality (float32, float64, int32), pads wider
than the axis included.  Profiling: ``trace`` writes a trace naming the
annotation; ``chip_spec`` reads the card's name; ``kernel_work`` at the
headline shapes gives the counts the card's runs print (K1 0.616 GFLOP and
36.885 MB at 48 x 177,664; K2's least 1.085 GFLOP at 32 x 277,632;
512/160/80 0.717 GFLOP and 51.1 MB at 48 x 177,664); ``speed_of_light``
orders its bounds; ``pipeline_costs`` names the lowering the dispatch takes
on each device and ``pallas`` setting."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mfcc_rust_tpu.utils import padding as jpad

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch.utils import padding as ppad
from mfcc_rust_tpu_torch.utils import profiling as prof

# ------------------------------------------------------------------ padding --
SHAPES = [(5,), (4, 3), (2, 3, 4)]
# per-axis (before, after): inside the axis, as wide as it, and wider (the
# reflection repeats)
WIDTHS = {"narrow": (2, 1), "axis-wide": (3, 4), "wider": (7, 11)}
DTYPES = ["float32", "float64", "int32"]


def _array(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "int32":
        return rng.integers(-100, 100, shape).astype(np.int32)
    return rng.normal(size=shape).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{len(s)}-D")
@pytest.mark.parametrize("mode", ppad.PAD_MODES)
def test_pad_matches_numpy_and_jax(mode, shape, width, dtype):
    x = _array(shape, dtype)
    pw = [WIDTHS[width]] * len(shape)
    ref = np.pad(x, pw, mode=mode)
    got = ppad.pad(torch.from_numpy(x), pw, mode).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(jpad.pad(jnp.asarray(x), pw, mode)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_pad_constant_value(dtype):
    x = _array((2, 3), dtype, seed=1)
    pw = [(1, 2), (0, 3)]
    got = ppad.pad(torch.from_numpy(x), pw, "constant", 7).numpy()
    np.testing.assert_array_equal(got, np.pad(x, pw, constant_values=7))
    np.testing.assert_array_equal(got, np.asarray(jpad.pad(jnp.asarray(x), pw, "constant", 7)))


def test_pad_unknown_mode():
    with pytest.raises(ValueError, match="unknown pad mode"):
        ppad.pad(torch.ones(2, 2), [(1, 1), (1, 1)], "wrap")
    with pytest.raises(ValueError):
        jpad.pad(jnp.ones((2, 2)), [(1, 1), (1, 1)], "wrap")


def test_repeat_axis_matches_reference_vectors():
    # the reference's own test vectors (util.rs:389-413), as tests/test_utils.py
    a = torch.tensor([0, 1, 2])
    np.testing.assert_array_equal(ppad.repeat_axis(a[None, :], 0, 2).numpy(),
                                  np.tile([0, 1, 2], (2, 1)))
    b = torch.tensor([[1, 2], [3, 4]])
    np.testing.assert_array_equal(ppad.repeat_axis(b, 0, 2).numpy(),
                                  np.tile([[1, 2], [3, 4]], (2, 1)))
    x = _array((2, 3, 4), "float64")
    for axis in range(3):
        np.testing.assert_array_equal(ppad.repeat_axis(torch.from_numpy(x), axis, 3).numpy(),
                                      np.asarray(jpad.repeat_axis(jnp.asarray(x), axis, 3)))


def test_pad_center():
    np.testing.assert_array_equal(ppad.pad_center(torch.ones(3), 7).numpy(),
                                  [0, 0, 1, 1, 1, 0, 0])
    x = _array((2, 5), "float32")
    np.testing.assert_array_equal(ppad.pad_center(torch.from_numpy(x), 10).numpy(),
                                  np.asarray(jpad.pad_center(jnp.asarray(x), 10)))
    with pytest.raises(ValueError):
        ppad.pad_center(torch.ones(5), 3)


def test_array_log():
    x = np.abs(_array((3, 4), "float64")) + 0.1
    np.testing.assert_allclose(ppad.array_log(torch.from_numpy(x)).numpy(),
                               np.asarray(jpad.array_log(jnp.asarray(x))), rtol=1e-12)


def test_utils_package_names_its_modules():
    from mfcc_rust_tpu_torch import utils

    assert all(hasattr(utils, n) for n in ("bucketing", "padding", "profiling"))


# ---------------------------------------------------------------- profiling --
def test_trace_writes_the_annotation(tmp_path):
    log_dir = tmp_path / "tr"
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 0.1, 16000).astype(np.float32))

    @prof.annotate("decorated_stage")
    def stage():
        return P.mfcc(x.numpy(), 16000, device="cpu")

    with prof.trace(str(log_dir)) as where:
        with prof.annotate("mfcc_stage"):
            stage()
    assert where == str(log_dir)
    files = list(log_dir.rglob("*.json"))
    assert files, "no trace written"
    text = "".join(f.read_text() for f in files)
    events = json.loads(files[0].read_text())["traceEvents"]
    assert "mfcc_stage" in text and "decorated_stage" in text
    assert any(e.get("name") == "mfcc_stage" for e in events)


CHIPS = [
    ("NVIDIA H100 80GB HBM3", "H100 SXM", 67.0, 3350.0),
    ("NVIDIA H100 PCIe", "H100 PCIe", 51.0, 2000.0),
    ("NVIDIA A100-SXM4-80GB", "H100 SXM (assumed)", 67.0, 3350.0),
]


@pytest.mark.parametrize("name,chip,tflops,gbs", CHIPS, ids=[c[1] for c in CHIPS])
def test_chip_spec(name, chip, tflops, gbs):
    spec = prof.chip_spec(name)
    assert spec == {"fp32_tflops": tflops, "hbm_gbs": gbs, "chip": chip}


def test_chip_spec_defaults_to_the_card():
    if torch.cuda.is_available():
        assert prof.chip_spec() == prof.chip_spec(torch.cuda.get_device_name())
    else:
        assert prof.chip_spec()["chip"] == "H100 SXM (assumed)"


# (cfg, feature, batch, samples, GFLOP of the count, MB or None, least GFLOP)
HEADLINES = [
    ("K1 48 x 177,664", P.speechpy_config(16000), "mfcc", 48, 177664, 0.616, 36.885, 0.616),
    ("K2 32 x 277,632", P.librosa_config(22050).replace(center=False),
     "mel_spectrogram_librosa", 32, 277632, 1.313, 44.402, 1.085),
    ("K2 512/160/80", P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80)
     .replace(center=False), "mel_spectrogram_librosa", 48, 177664, 0.717, 51.139, 0.717),
]


@pytest.mark.parametrize("name,cfg,feature,b,t,gflop,mb,least", HEADLINES,
                         ids=[h[0] for h in HEADLINES])
def test_kernel_work_at_the_headlines(name, cfg, feature, b, t, gflop, mb, least):
    flops, nbytes = prof.kernel_work(cfg, feature, b, t)
    w = prof.work(cfg, feature, b, t)
    assert w["lowering"] in ("k1", "k2")
    assert round(flops / 1e9, 3) == gflop and round(nbytes / 1e6, 3) == mb
    assert round(w["least_flops"] / 1e9, 3) == least
    # the bound the card's run prints: the least count over 67 TFLOP/s
    # against the bytes over 3.35 TB/s
    secs, by = prof.bound_seconds(w["least_flops"], nbytes, prof.chip_spec("H100 80GB HBM3"))
    assert secs == max(w["least_flops"] / 67e12, nbytes / 3.35e12)
    assert by == ("operations" if w["least_flops"] / 67e12 >= nbytes / 3.35e12 else "bytes")


def test_k2_centre_pad_counts_the_padded_signal():
    cfg = P.librosa_config(22050)
    assert prof.work(cfg, "mel_spectrogram_librosa", 2, 20000)["frames"] == 1 + 20000 // 512
    assert prof.kernel_work(cfg, "mel_spectrogram_librosa", 2, 20000) == \
        prof.kernel_work(cfg.replace(center=False), "mel_spectrogram_librosa", 2, 20000 + 2048)


CFG = P.speechpy_config(16000)
LOWERINGS = [
    # (feature, cfg, device_type, lowering)
    ("mfcc", CFG, "cuda", "k1"),
    ("mfcc", CFG.replace(pallas="off"), "cuda", "chunk-gemm"),
    ("mfcc", CFG, "cpu", "chunk-gemm"),
    ("mfcc", CFG.replace(dtype="float64"), "cuda", "chunk-gemm"),
    ("mfcc", CFG.replace(fft_impl="fft"), "cuda", "framed"),
    ("mfe", CFG, "cuda", "chunk-gemm"),
    ("lmfe", CFG, "cuda", "chunk-gemm"),
    ("ssc", CFG, "cuda", "chunk-gemm"),
    (("mfcc", "ssc"), CFG, "cuda", "chunk-gemm-multi"),
    (("mfcc", "lmfe"), CFG.replace(fft_impl="fft"), "cpu", "framed-multi"),
    ("mel_spectrogram", P.vorbis_config(16000), "cuda", "vorbis-chunk-gemm"),
    ("mel_spectrogram", P.vorbis_config(16000, fft_impl="fft"), "cuda", "vorbis-framed"),
    ("mel_spectrogram_librosa", P.librosa_config(22050), "cuda", "k2"),
    ("mel_spectrogram_librosa", P.librosa_config(22050), "cpu", "librosa-ct"),
    ("mel_spectrogram_librosa", P.librosa_config(22050, pallas="off"), "cuda", "librosa-ct"),
    ("mel_spectrogram_librosa", P.librosa_config(16000, n_fft=512, hop_length=128), "cpu",
     "librosa-chunk-gemm"),
    ("mel_spectrogram_librosa", P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80),
     "cpu", "librosa-hoppad"),
    ("mel_spectrogram_librosa", P.librosa_config(22050, fft_impl="fft"), "cuda",
     "librosa-framed"),
    ("mfcc_librosa", P.librosa_config(22050), "cuda", "k2"),
    ("mfcc_librosa", P.librosa_config(22050), "cpu", "librosa-ct"),
]


@pytest.mark.parametrize("feature,cfg,device,lowering", LOWERINGS,
                         ids=[f"{f}-{d}-{low}" for f, _, d, low in LOWERINGS])
def test_pipeline_costs_names_the_dispatched_lowering(feature, cfg, device, lowering):
    costs = prof.pipeline_costs(cfg, feature, device)
    assert costs["lowering"] == lowering
    assert costs["flops_per_audio_second"] > 0 or lowering.endswith("framed")
    assert costs["least_flops_per_audio_second"] <= costs["flops_per_audio_second"]
    assert costs["hbm_bytes_per_audio_second"] > 4 * cfg.sample_rate * 0.99
    assert ("gemms_per_frame" in costs) == (lowering not in ("k1", "k2"))
    if "gemms_per_frame" in costs:
        fps = costs["frames_per_audio_second"]
        prods = sum(2.0 * k * n * per for k, n, per in costs["gemms_per_frame"])
        assert prods * fps == pytest.approx(costs["flops_per_audio_second"], rel=1e-9)


def test_lowering_names_come_from_the_dispatch():
    """On the CPU the dispatch runs the lowering the model names: the
    K1-less chunk-GEMM is the one product of the chunk wall's shape."""
    from mfcc_rust_tpu_torch import features as PF

    assert PF.speechpy_lowering(CFG, "mfcc", "cpu", torch.float32) == \
        prof.pipeline_costs(CFG, "mfcc", "cpu")["lowering"]
    gemms = prof.pipeline_costs(CFG, "mfcc", "cpu")["gemms_per_frame"]
    wall = PF._speechpy_tensors(CFG, torch.device("cpu"), torch.float32)["wall"]
    assert gemms[0][:2] == tuple(wall.shape) and gemms[0][2] == 1


SOL_CASES = [
    ("mfcc", CFG),
    ("mfcc", CFG.replace(pallas="off")),
    ("ssc", CFG),
    (("mfcc", "lmfe", "mfe", "ssc"), CFG),
    ("mel_spectrogram", P.vorbis_config(16000)),
    ("mel_spectrogram_librosa", P.librosa_config(22050)),
    ("mfcc_librosa", P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80)),
]


@pytest.mark.parametrize("feature,cfg", SOL_CASES, ids=[str(c[0]) for c in SOL_CASES])
def test_speed_of_light_orders_its_bounds(feature, cfg):
    sol = prof.speed_of_light(cfg, feature, device_name="NVIDIA H100 80GB HBM3")
    assert sol["chip"] == "H100 SXM"
    assert sol["lowering"] == prof.pipeline_costs(cfg, feature)["lowering"]
    assert 0 < sol["speed_of_light_audio_s_per_s"] <= sol["bandwidth_bound_audio_s_per_s"]
    assert sol["speed_of_light_audio_s_per_s"] <= sol["compute_bound_audio_s_per_s"]
    assert sol["speed_of_light_audio_s_per_s"] == min(sol["compute_bound_audio_s_per_s"],
                                                      sol["bandwidth_bound_audio_s_per_s"])
    # a slower card bounds lower
    pcie = prof.speed_of_light(cfg, feature, spec=prof.chip_spec("NVIDIA H100 PCIe"))
    assert pcie["speed_of_light_audio_s_per_s"] < sol["speed_of_light_audio_s_per_s"]


def test_speed_of_light_k2_bound_takes_the_least_count():
    cfg = P.librosa_config(22050)
    sol = prof.speed_of_light(cfg, "mel_spectrogram_librosa", spec=prof.CHIP_SPECS["H100 SXM"])
    costs = prof.pipeline_costs(cfg, "mel_spectrogram_librosa")
    assert costs["least_flops_per_audio_second"] < costs["flops_per_audio_second"]
    assert sol["compute_bound_audio_s_per_s"] == pytest.approx(
        67e12 / costs["least_flops_per_audio_second"], rel=1e-12)
