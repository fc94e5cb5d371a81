"""The fused speechpy-MFCC kernel module of the PyTorch port
(``mfcc_rust_tpu_torch/ops/cuda/speechpy_mfcc.py``).

On the CPU its plain version, ``mfcc_fused_plain``, is held against the JAX
Pallas kernel ``mfcc_pallas`` run in interpret mode (``pallas="force"`` on
the CPU backend, as ``tests/test_pallas.py`` runs it) at max|Δ|/max|ref| <=
1e-5: two float32 programs that sum in different orders.  The CUDA kernel
itself runs only on the card: ``tests/test_torch_port_cuda.py`` holds it
to the plain version there."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mfcc_rust_tpu as m
from mfcc_rust_tpu import features as JF
from mfcc_rust_tpu.ops.pallas import speechpy_mfcc as jk

import mfcc_rust_tpu_torch as P
from mfcc_rust_tpu_torch import features as PF
from mfcc_rust_tpu_torch.ops import framing as pframing
from mfcc_rust_tpu_torch.ops.cuda import speechpy_mfcc as pk

CONFIGS = [
    ("default 20/10", {}, (2, 8000)),
    ("25/10 r=3", {"frame_length": 0.025}, (2, 8000)),
    ("preemph 0.97", {"preemphasis_cof": 0.97}, (2, 8000)),
    ("no dc_elim", {"dc_elimination": False}, (2, 8000)),
    ("r=1 10/10", {"frame_length": 0.01}, (2, 8000)),
    ("batched 3-D", {}, (2, 2, 4000)),
    ("T < fl", {}, (300,)),
]


def rel(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape, (a.shape, ref.shape)
    if ref.size == 0:
        return 0.0
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def _pair(kw, shape, seed):
    jcfg = m.speechpy_config(16000, **kw)
    pcfg = P.from_reference(dataclasses.asdict(jcfg))
    x = np.random.default_rng(seed).normal(0, 0.1, shape).astype(np.float32)
    return jcfg, pcfg, x


@pytest.mark.parametrize("name,kw,shape", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_fused_plain_matches_jax_kernel(name, kw, shape):
    jcfg, pcfg, x = _pair(kw, shape, seed=11)
    ref = np.asarray(JF.mfcc(jnp.asarray(x), jcfg.replace(pallas="force")))
    px = torch.from_numpy(x)
    if pcfg.preemphasis_cof:
        px = pframing.preemphasis(px, 1, pcfg.preemphasis_cof)
    out = pk.mfcc_fused_plain(px, pcfg)
    assert out.dtype == torch.float32
    assert rel(out, ref) <= 1e-5, name
    if name == "T < fl":
        assert out.shape == (0, 13)


@pytest.mark.parametrize("name,kw,shape", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_cpu_wrapper_runs_plain_and_counts_nothing(name, kw, shape):
    """On a CPU tensor the wrapper is the plain version and launches nothing;
    the main-path mfcc agrees with the unfused chunk-GEMM path."""
    _, pcfg, x = _pair(kw, shape, seed=12)
    px = torch.from_numpy(x)
    before = pk.mfcc_fused.launches
    fused = pk.mfcc_fused(px, pcfg)
    assert pk.mfcc_fused.launches == before
    assert torch.equal(fused, pk.mfcc_fused_plain(px, pcfg))
    plain = PF.mfcc(px, pcfg.replace(pallas="off"))
    x_in = pframing.preemphasis(px, 1, pcfg.preemphasis_cof) if pcfg.preemphasis_cof else px
    assert rel(pk.mfcc_fused_plain(x_in, pcfg), plain) <= 1e-5, name


SUPPORT = [
    ("default", {}),
    ("25/10", {"frame_length": 0.025}),
    ("hann", {"window": "hann"}),
    ("float64", {"dtype": "float64"}),
    ("fft impl", {"fft_impl": "fft"}),
    ("odd fft", {"fft_points": 511}),
    ("frame > fft", {"frame_length": 0.04}),
    ("frame < hop", {"frame_length": 0.005}),
    ("r > 8", {"frame_length": 0.02, "frame_stride": 0.002}),
    ("ncep > nfilt", {"num_cepstral": 20, "num_filters": 16}),
    ("8k 1024 26 mels", {"fft_points": 1024, "num_filters": 26}),
]


@pytest.mark.parametrize("name,kw", SUPPORT, ids=[s[0] for s in SUPPORT])
def test_support_predicate_matches_jax(name, kw):
    """The port's predicate is the JAX one (which has no precision test of
    its own; the precision gate sits in the JAX dispatcher) wherever both
    bounds hold: the TPU lane bound num_filters <= 127 is dropped."""
    jcfg = m.speechpy_config(16000, **kw)
    pcfg = P.from_reference(dataclasses.asdict(jcfg))
    assert pk.mfcc_kernel_supported(pcfg) == jk.mfcc_pallas_supported(jcfg), name


def test_support_predicate_drops_tpu_lane_bound():
    pcfg = P.speechpy_config(16000, num_filters=128)
    assert pk.mfcc_kernel_supported(pcfg)
    _, wpack, _, _, kmax = pk._kernel_constants(pcfg)
    assert pk.smem_bytes(512, 160, 320, kmax, wpack.size, 128, 8) <= 232448
    # a tile that cannot fit in shared memory is refused, not launched
    assert not pk.mfcc_kernel_supported(
        P.speechpy_config(16000, fft_points=4096, frame_length=0.2,
                          frame_stride=0.1, fft_impl="matmul"))


def test_wrapper_refuses_unsupported_config():
    with pytest.raises(ValueError):
        pk.mfcc_fused(torch.zeros(1000), P.speechpy_config(16000, window="hann"))


def test_autograd_function_matches_plain_grad():
    """The kernel's autograd.Function (its forward is the plain version on
    the CPU) recomputes its backward through the chunk-GEMM path."""
    cfg = P.speechpy_config(16000, preemphasis_cof=0.97)
    x = torch.from_numpy(np.random.default_rng(13).normal(0, 0.1, (2, 4000)).astype(np.float32))
    a = x.clone().requires_grad_(True)
    out = PF._MFCCKernel.apply(a, cfg, None)
    w = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
    (out * w).sum().backward()
    b = x.clone().requires_grad_(True)
    (PF.mfcc(b, cfg.replace(pallas="off")) * w).sum().backward()
    assert rel(out.detach(), PF.mfcc(x, cfg.replace(pallas="off"))) <= 1e-5
    assert rel(a.grad, b.grad) <= 1e-5
