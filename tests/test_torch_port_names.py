"""The last public names of the JAX package that the port had lacked, each
held to the reference: ``features.vmapped``, ``ops.framing.frame_indices``
and ``parallel.mesh.initialize_multihost`` (on a gloo world of two through
``tests/test_torch_port_dist_worker.py``'s ``multihost`` task).

Tolerance of the mapped pipelines, max|Δ| / max|ref|: float64 1e-9, float32
1e-5 (two float32 programs that sum in different orders, as in
``test_torch_port_features.py``)."""

import json
import socket

import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
from mfcc_rust_tpu import features as JF
from mfcc_rust_tpu.ops import framing as jframing
from tests.test_torch_port_parallel import run_world

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops import framing as pframing
from mfcc_rust_tpu_torch.parallel import mesh as pmesh

TOL = {"float32": 1e-5, "float64": 1e-9}


def rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("in_axes", [0, 1])
@pytest.mark.parametrize("fn", ["mfcc", "mel_spectrogram_librosa"])
def test_vmapped_matches_jax(fn, in_axes, dtype):
    if fn == "mfcc":
        jcfg, pcfg, t = m.speechpy_config(16000), P.speechpy_config(16000), 4000
    else:
        jcfg = m.librosa_config(16000, n_fft=512, hop_length=160, n_mels=40)
        pcfg = P.librosa_config(16000, n_fft=512, hop_length=160, n_mels=40)
        t = 4096
    jcfg, pcfg = jcfg.replace(dtype=dtype), pcfg.replace(dtype=dtype)
    x = np.random.default_rng(3).normal(0, 0.1, (3, t)).astype(dtype)
    if in_axes == 1:
        x = np.ascontiguousarray(x.T)
    want = np.asarray(JF.vmapped(getattr(JF, fn), in_axes)(x, jcfg))
    got = PF.vmapped(getattr(PF, fn), in_axes)(torch.from_numpy(x), pcfg)
    assert tuple(got.shape) == want.shape and want.shape[0] == 3
    assert rel(got, want) <= TOL[dtype]
    # one batched call: the same as the pipeline on the (3, T) batch
    assert torch.equal(got, getattr(PF, fn)(torch.from_numpy(x).movedim(in_axes, 0), pcfg))


@pytest.mark.parametrize("num_frames,frame_len,frame_step",
                         [(0, 320, 160), (1, 320, 160), (98, 320, 160), (7, 400, 160),
                          (5, 160, 160), (3, 512, 100)])
def test_frame_indices_equal_jax(num_frames, frame_len, frame_step):
    want = jframing.frame_indices(num_frames, frame_len, frame_step)
    got = pframing.frame_indices(num_frames, frame_len, frame_step)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # the gather takes the frames that frame_signal views
    x = torch.arange(max(num_frames - 1, 0) * frame_step + frame_len, dtype=torch.float64)
    np.testing.assert_array_equal(
        x.numpy()[got], pframing.frame_signal(x, frame_len, frame_step, num_frames).numpy())


def test_initialize_multihost_alone_is_the_one_rank_world():
    assert pmesh.initialize_multihost() == (0, 1)
    assert pmesh.initialize_multihost(num_processes=1, device="cpu") == (0, 1)
    assert not torch.distributed.is_initialized()


def test_initialize_multihost_joins_a_two_process_world(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    run_world("multihost", tmp_path, 2, (f"127.0.0.1:{port}",))
    for r in range(2):
        got = json.loads((tmp_path / f"multihost.rank{r}.json").read_text())
        assert got == {"rank_world": [r, 2], "sum": 3.0}
