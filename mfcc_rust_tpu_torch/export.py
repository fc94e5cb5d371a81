"""Pipeline export for inference embedding (port of ``mfcc_rust_tpu.export``).

The JAX package serializes a jitted pipeline with ``jax.export`` to
StableHLO.  Here ``torch.export`` traces a pipeline module
(:mod:`.models.pipelines`, its constants held as buffers) for one static
input shape into an ``ExportedProgram``, which ``torch.export.save`` writes
as a ``.pt2`` archive that a later PyTorch process loads and calls without
this package, plus inspection helpers (the graph as text, a FLOP count).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from .config import FeatureConfig, fp32_matmul
from .models import pipelines as _pipelines
from .utils.device import resolve_device

# the feature functions the JAX package's export reaches by getattr(F, name)
PIPELINES = {
    "mfcc": _pipelines.MFCCPipeline,
    "mfe": _pipelines.MFEPipeline,
    "lmfe": _pipelines.LogMFEPipeline,
    "ssc": _pipelines.SSCPipeline,
    "mel_spectrogram": _pipelines.MelSpectrogramPipeline,
    "mel_spectrogram_librosa": _pipelines.LibrosaMelPipeline,
    "mfcc_librosa": _pipelines.LibrosaMFCCPipeline,
}


def _pipeline_fn(cfg: FeatureConfig, feature: str, device=None) -> torch.nn.Module:
    """The pipeline module of ``feature`` on ``device``, holding its
    constants as buffers.  Exports always take the plain lowering
    (``pallas="off"``): the port's kernels are calls through ``ctypes``
    that no trace can see, as the JAX package's Pallas kernels are Mosaic
    calls that no other backend could run."""
    if feature not in PIPELINES:
        raise ValueError(f"unknown feature {feature!r}; expected one of {sorted(PIPELINES)}")
    if cfg.pallas != "off":
        cfg = cfg.replace(pallas="off")
    return PIPELINES[feature](cfg, device=device, hold_constants=True).eval()


def export_pipeline(
    cfg: FeatureConfig,
    feature: str = "mfcc",
    signal_shape: Sequence[int] = (1, 16000),
    path: Optional[str] = None,
    device=None,
):
    """Trace a feature pipeline for ``signal_shape`` inputs of ``cfg.dtype``
    on ``device`` (default CUDA; the counterpart of JAX's ``platforms``).
    Returns the ``torch.export.ExportedProgram``; with ``path`` it is also
    saved there (by convention a ``.pt2`` file).  The shape is static."""
    dev = resolve_device(device)
    module = _pipeline_fn(cfg, feature, dev)
    x = torch.zeros(tuple(signal_shape), dtype=getattr(torch, cfg.dtype), device=dev)
    with fp32_matmul():
        exported = torch.export.export(module, (x,))
    # the zero input traced on is no data: saved with the program it would
    # make the artifact the size of one input batch
    exported.example_inputs = None
    if path is not None:
        torch.export.save(exported, path)
    return exported


def load_pipeline(path: str, device=None) -> Callable:
    """Load an exported pipeline onto ``device`` (default CUDA; an artifact
    traced on another device is moved); returns a callable ``fn(signal)``.
    Each call runs under :func:`.config.fp32_matmul`: the trace records no
    matmul precision, so the caller's TF32 setting would otherwise change
    the results."""
    from torch.export.passes import move_to_device_pass

    dev = resolve_device(device)
    module = move_to_device_pass(torch.export.load(path), dev).module()

    def fn(signal):
        with fp32_matmul():
            return module(torch.as_tensor(signal, device=dev))

    return fn


def graph_text(cfg: FeatureConfig, feature: str = "mfcc",
               signal_shape: Sequence[int] = (1, 16000), device=None) -> str:
    """The exported graph as text, for inspection: the counterpart of the
    JAX package's ``stablehlo_text``."""
    return str(export_pipeline(cfg, feature, signal_shape, device=device).graph_module.code)


def flops_estimate(cfg: FeatureConfig, feature: str = "mfcc",
                   signal_shape: Sequence[int] = (1, 16000), device=None) -> Optional[float]:
    """``torch.utils.flop_counter.FlopCounterMode``'s count of one call of
    the exported program on a zero input: the counterpart of XLA's cost
    analysis.  The counter counts products (``mm``, ``bmm``, ``addmm``,
    convolutions), a multiply-add as two; None when it counts nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    dev = resolve_device(device)
    module = export_pipeline(cfg, feature, signal_shape, device=dev).module()
    x = torch.zeros(tuple(signal_shape), dtype=getattr(torch, cfg.dtype), device=dev)
    counter = FlopCounterMode(display=False)
    with counter, fp32_matmul():
        module(x)
    total = counter.get_total_flops()
    return float(total) if total else None
