"""The port's entry module (``mfcc_rust_tpu_torch.entry``) against
``__graft_entry__.py``: ``entry()``'s forward step on the same seeded
input, and ``dryrun_multichip`` on gloo worlds of CPU ranks.

Tolerances (max|Δ| / max|ref|): float64 1e-9.  Float32 1e-4, the kernels'
tolerance: on the (8, 16000) batch (784 frames) the two float32 chunk-GEMM
programs sum in different orders and read 6.1e-5 apart at one frame, where
each lies within 4e-5 of the float64 value (the 1e-5 of
``test_torch_port_features.py`` holds on its 98-frame inputs, not here);
the port is also held to the float64 result at 1e-4."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as G
from tests import test_torch_port_dist_worker as worker

from mfcc_rust_tpu_torch import entry as E

ROOT = Path(__file__).resolve().parents[1]


def rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def signals():
    return np.random.default_rng(0).normal(0, 0.1, (8, 16000))


def test_entry_fn_matches_jax_float32(signals):
    jfn, _ = G.entry()
    pfn, _ = E.entry(device="cpu")
    x = signals.astype(np.float32)
    got = pfn(torch.from_numpy(x))
    want = np.asarray(jfn(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (8, 98, 13)
    assert rel(got, want) <= 1e-4
    assert rel(got, np.asarray(jfn(signals))) <= 1e-4


def test_entry_fn_matches_jax_float64(signals):
    jfn, _ = G.entry()
    pfn, _ = E.entry(device="cpu")
    got = pfn(torch.from_numpy(signals))
    assert got.dtype == torch.float64
    assert rel(got, np.asarray(jfn(signals))) <= 1e-9


def test_example_args_match_the_reference():
    _, (jx,) = G.entry()
    _, args = E.entry(device="cpu")
    assert len(args) == 1
    (x,) = args
    assert tuple(x.shape) == tuple(jx.shape) == (8, 16000)
    assert x.dtype == torch.float32 and x.device.type == "cpu" and not bool(x.any())


def test_defaults_are_cuda_and_raise_without_it():
    """In a process that sees no card, the defaults resolve to CUDA and
    raise, and asking for CUDA ranks raises instead of running on the
    CPU."""
    code = textwrap.dedent("""
        import pytest, torch
        from mfcc_rust_tpu_torch import entry as E
        assert not torch.cuda.is_available()
        with pytest.raises(RuntimeError, match="CUDA"):
            E.entry()
        for n in (1, 2):
            with pytest.raises(RuntimeError, match="CUDA"):
                E.dryrun_multichip(n)
        with pytest.raises(RuntimeError, match="CUDA"):
            E.dryrun_multichip(2, device="cuda")
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-4000:]


@pytest.mark.parametrize("n,mesh", [(1, [1, 1]), (2, [2, 1]), (4, [2, 2])])
def test_dryrun_multichip_on_cpu_ranks(n, mesh):
    out = E.dryrun_multichip(n, device="cpu")
    assert out["mesh"] == mesh
    n_data, n_seq = mesh
    assert (out["batch"], out["time"]) == (2 * n_data, 160 * 8 * n_seq)
    assert out["runner_dispatches"] >= 1 and out["corpus_frames"] > 0


def test_a_failing_rank_makes_the_spawn_raise():
    with pytest.raises(Exception, match="fault injected on rank 1"):
        E._spawn(2, torch.device("cpu"), worker.faulty_rank, timeout=120.0)
