"""Export a pipeline for inference embedding with the PyTorch port.

Any feature pipeline traces to a ``torch.export`` program saved as a
``.pt2`` file, which an inference process loads and calls on its own
device.  The export takes the plain PyTorch lowering (the kernels are
``ctypes`` calls that no trace sees), so this example launches no kernel.

Run: python examples_torch/export_inference.py [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import tempfile

import numpy as np
import torch

import mfcc_rust_tpu_torch as ss
from mfcc_rust_tpu_torch import FeatureConfig
from mfcc_rust_tpu_torch.export import export_pipeline, graph_text, load_pipeline

ap = argparse.ArgumentParser(description="export and inference")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = ap.parse_args().device

cfg = FeatureConfig(sample_rate=16000)
artifact = tempfile.mktemp(suffix=".pt2")

export_pipeline(cfg, "mfcc", signal_shape=(1, 16000), path=artifact, device=dev)
print("exported:", artifact)

# "inference side": load and call without touching the feature library
fn = load_pipeline(artifact, device=dev)
signal = np.random.default_rng(0).normal(0, 0.1, (1, 16000)).astype(np.float32)
feats = fn(signal)
print("inference output:", tuple(feats.shape))

ref = ss.mfcc(signal[0], 16000, bucket=False, device=dev)
# held at 1e-4 of max|ref|, the kernels' tolerance: on the card the
# library call runs the fused kernel (an FFT) and the export the plain
# chunk-GEMM lowering, both in IEEE float32 with their sums in different
# orders; on the CPU both run the same lowering and agree exactly
err = float((feats[0] - ref).abs().max())
print("matches library:", err <= 1e-4 * float(ref.abs().max()))

graph = graph_text(cfg, "mfcc", (1, 16000), device=dev)
print("graph ops: matmul" if "matmul" in graph else "?",
      "| fft-free:", "fft" not in graph)
