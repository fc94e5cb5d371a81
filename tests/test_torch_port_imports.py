"""The PyTorch port stands alone: importing it pulls in neither JAX nor the
JAX package, its entry points refuse to run on a missing GPU unless asked
for the CPU, and its copies of the constant builders equal the originals."""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
from mfcc_rust_tpu import constants as jc
from mfcc_rust_tpu.ops.pallas import speechpy_mfcc as jk

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import constants as pc
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as pk

ROOT = Path(__file__).resolve().parents[1]


def test_import_pulls_in_no_jax_and_needs_cuda_by_default():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import mfcc_rust_tpu_torch as P
        import mfcc_rust_tpu_torch.models, mfcc_rust_tpu_torch.ops.cuda.build
        import mfcc_rust_tpu_torch.models.incremental
        import mfcc_rust_tpu_torch.compat.speechpy, mfcc_rust_tpu_torch.transforms
        bad = [k for k in sys.modules
               if k.split('.')[0] in ('jax', 'jaxlib', 'mfcc_rust_tpu')]
        assert not bad, bad
        assert not torch.cuda.is_available()
        x = np.zeros(16000, np.float32)
        for fn in (P.mfcc, P.mfe, P.lmfe, P.mel_spectrogram_librosa,
                   P.log_mel_spectrogram, P.mfcc_librosa):
            try:
                fn(x, 16000)
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise AssertionError(fn.__name__ + " ran without CUDA")
        for pipe, cfg in ((P.MFCCPipeline, P.speechpy_config(16000)),
                          (P.LibrosaMelPipeline, P.librosa_config()),
                          (P.LibrosaMFCCPipeline, P.librosa_config())):
            try:
                pipe(cfg)
            except RuntimeError:
                pass
            else:
                raise AssertionError(pipe.__name__ + " built without CUDA")
        assert P.mfcc(x, 16000, device="cpu").shape == (98, 13)
        assert P.mel_spectrogram_librosa(x, 16000, device="cpu").shape == (128, 32)
        assert P.log_mel_spectrogram(x, 16000, device="cpu").shape == (128, 32)
        assert P.mfcc_librosa(x, 16000, device="cpu").shape == (20, 32)
        assert P.LibrosaMelPipeline(P.librosa_config(), device="cpu")(
            torch.from_numpy(x)).shape == (128, 32)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_streaming_sessions_need_cuda_and_pull_in_no_jax():
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from mfcc_rust_tpu_torch.models import StreamingExtractor, StreamingFeatures
        from mfcc_rust_tpu_torch.models.incremental import IncrementalFrontend
        from mfcc_rust_tpu_torch.ops import stft
        assert not torch.cuda.is_available()
        import mfcc_rust_tpu_torch as P
        for make in (StreamingFeatures, StreamingExtractor,
                     lambda: StreamingFeatures(feature="mel_librosa"),
                     lambda: IncrementalFrontend(P.speechpy_config(16000), "mfcc"),
                     lambda: stft.streaming_init(P.vorbis_config(16000))):
            try:
                make()
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise AssertionError("a streaming session was built without CUDA")
        x = np.zeros(16000, np.float32)
        out = StreamingFeatures(device="cpu").process(x)
        assert out.device.type == "cpu" and tuple(out.shape) == (98, 13)
        sx = StreamingExtractor(device="cpu")
        assert tuple(sx.process(x).shape) == (50, 40)
        assert tuple(sx.finalize().shape) == (0, 40)
        bad = [k for k in sys.modules
               if k.split('.')[0] in ('jax', 'jaxlib', 'mfcc_rust_tpu')]
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_corpus_path_pulls_in_no_jax_and_needs_cuda_by_default():
    code = textwrap.dedent("""
        import sys
        import torch
        import mfcc_rust_tpu_torch.parallel, mfcc_rust_tpu_torch.runtime
        import mfcc_rust_tpu_torch.parallel.runner, mfcc_rust_tpu_torch.utils.profiling
        from mfcc_rust_tpu_torch.parallel import make_mesh
        from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner
        bad = [k for k in sys.modules
               if k.split('.')[0] in ('jax', 'jaxlib', 'mfcc_rust_tpu')]
        assert not bad, bad
        assert not torch.cuda.is_available()
        for make in (make_mesh, lambda: CorpusRunner([])):
            try:
                make()
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise AssertionError("the corpus path ran without CUDA")
        mesh = make_mesh(device="cpu")
        assert mesh.size == 1 and mesh.group is None and mesh.device.type == "cpu"
        assert CorpusRunner([], device="cpu").mesh.device.type == "cpu"
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_export_cli_and_utils_pull_in_no_jax_and_need_cuda_by_default(tmp_path):
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        import mfcc_rust_tpu_torch.export as E
        import mfcc_rust_tpu_torch.cli
        import mfcc_rust_tpu_torch.utils.padding, mfcc_rust_tpu_torch.utils.profiling
        import mfcc_rust_tpu_torch as P
        bad = [k for k in sys.modules
               if k.split('.')[0] in ('jax', 'jaxlib', 'mfcc_rust_tpu')]
        assert not bad, bad
        assert not torch.cuda.is_available()
        cfg = P.speechpy_config(16000)
        for make in (lambda: E.export_pipeline(cfg), lambda: E.load_pipeline("x.pt2"),
                     lambda: E.graph_text(cfg), lambda: E.flops_estimate(cfg)):
            try:
                make()
            except RuntimeError as e:
                assert "CUDA" in str(e)
            else:
                raise AssertionError("export ran without CUDA")
        assert E.export_pipeline(cfg, signal_shape=(1, 4000), device="cpu") is not None
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr

    # python -m with jax, jaxlib and the JAX package shadowed by packages
    # that refuse to import: --help works, and a run without --device cpu
    # refuses for want of CUDA
    for name in ("jax", "jaxlib", "mfcc_rust_tpu"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(f"raise ImportError('{name} is blocked')\n")
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": f"{tmp_path}:{ROOT}"}
    res = subprocess.run([sys.executable, "-m", "mfcc_rust_tpu_torch", "--help"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode == 0 and "--device" in res.stdout, res.stderr
    wav = tmp_path / "a.wav"
    wav.write_bytes(b"")
    res = subprocess.run([sys.executable, "-m", "mfcc_rust_tpu_torch", str(wav), "--out-dir",
                          str(tmp_path / "o")], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env=env)
    assert res.returncode != 0 and "CUDA" in res.stderr, res.stderr


def test_port_sources_name_no_jax():
    files = list((ROOT / "mfcc_rust_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                  ROOT / "bench_torch.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "mfcc_rust_tpu"), (f, s)


def test_bench_torch_imports_no_jax():
    """The port's benchmark imports neither JAX nor the JAX package, even
    where both would import."""
    code = textwrap.dedent("""
        import sys
        import bench_torch
        bad = [k for k in sys.modules
               if k.split('.')[0] in ('jax', 'jaxlib', 'mfcc_rust_tpu')]
        assert not bad, bad
        assert bench_torch.LINES["headline"][1] == "mfcc"
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


PRESETS = [
    ("speechpy 20/10", m.speechpy_config(16000)),
    ("speechpy 25/10", m.speechpy_config(16000, frame_length=0.025)),
    ("speechpy 10/10", m.speechpy_config(16000, frame_length=0.01)),
    ("speechpy 8k 1024", m.speechpy_config(8000, fft_points=1024, num_filters=26,
                                           low_frequency=100.0, high_frequency=3000.0)),
    ("speechpy hann", m.speechpy_config(16000, window="hann")),
    ("librosa 22050/2048", m.librosa_config()),
    ("librosa 16k 512/160", m.librosa_config(16000, n_fft=512, hop_length=160, n_mels=80)),
    ("vorbis 48k", m.vorbis_config(48000, fft_points=960, frame_length=0.01)),
]


@pytest.mark.parametrize("name,cfg", PRESETS, ids=[p[0] for p in PRESETS])
def test_constants_equal_reference(name, cfg):
    pcfg = P.from_reference(dataclasses.asdict(cfg))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    jb, pb = jc.constant_bundle(cfg), pc.constant_bundle(pcfg)
    assert jb.keys() == pb.keys()
    for k in jb:
        a, b = jb[k], pb[k]
        if isinstance(a, tuple):
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), k
        else:
            assert np.array_equal(a, b), k
    if cfg.frame_size >= cfg.frame_step:
        for want_energy in (True, False):
            jw, pw = jc.chunk_gemm_wall(cfg, want_energy), pc.chunk_gemm_wall(pcfg, want_energy)
            assert jw.keys() == pw.keys()
            assert all(np.array_equal(jw[k], pw[k]) for k in jw), name
    if cfg.window == "vorbis":
        jv, pv = jc.vorbis_chunk_wall(cfg), pc.vorbis_chunk_wall(pcfg)
        assert all(np.array_equal(jv[k], pv[k]) for k in jv)
    if jk.mfcc_pallas_supported(cfg):
        # the TPU kernel's constants are those of the port's plain version
        wall, proj, dct, emask, r, hop, fl = jk._mfcc_constants(cfg)
        pt = PF._speechpy_tensors(pcfg, torch.device("cpu"), torch.float32)
        for a, k in ((wall, "wall"), (proj, "proj"), (dct, "dct")):
            assert np.array_equal(a, pt[k].numpy()), (name, k)
        assert pk._shape(pcfg, pt["wall"]) == (r, hop, fl), name
        assert np.array_equal(emask[0], np.arange(r * hop) < fl), name


LIBROSA_PRESETS = [
    ("librosa 22050/2048", (), {}),
    ("librosa 16k 512/160", (16000,), dict(n_fft=512, hop_length=160, n_mels=80)),
    ("librosa win 1024, fmin/fmax", (22050,), dict(win_length=1024, fmin=30.0, fmax=8000.0,
                                                  n_mfcc=13, power=1.0)),
]


@pytest.mark.parametrize("name,args,kw", LIBROSA_PRESETS, ids=[p[0] for p in LIBROSA_PRESETS])
def test_librosa_preset_equals_reference(name, args, kw):
    jcfg = m.librosa_config(*args, **kw)
    pcfg = P.librosa_config(*args, **kw)
    assert pcfg == P.from_reference(dataclasses.asdict(jcfg)), name
    assert (pcfg.frame_size, pcfg.frame_step, pcfg.win_length) == \
        (jcfg.frame_size, jcfg.frame_step, jcfg.win_length)


def test_from_reference_rejects_unknown_fields():
    d = dataclasses.asdict(m.speechpy_config(16000))
    d["mxu_passes"] = 3
    with pytest.raises(ValueError):
        P.from_reference(d)


def test_builder_matches_reference():
    jb = m.SpeechConfigBuilder(16000).fft_points(1024).num_cepstral(20).window("hann").build()
    pb = P.SpeechConfigBuilder(16000).fft_points(1024).num_cepstral(20).window("hann").build()
    assert dataclasses.asdict(jb) == dataclasses.asdict(pb)
    assert (pb.frame_size, pb.frame_step, pb.freq_size) == (jb.frame_size, jb.frame_step, jb.freq_size)
