"""Streaming mel extraction with the PyTorch port: explicit, resettable
state.

The session carry is explicit and the chunked stream equals the batch
transform up to float32 rounding.  No kernel runs here: the streaming STFT
and the mel projection are products on cuBLAS (or the CPU).

Run: python examples_torch/streaming.py [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import mfcc_rust_tpu_torch as ss
from mfcc_rust_tpu_torch import vorbis_config
from mfcc_rust_tpu_torch.models import StreamingExtractor

ap = argparse.ArgumentParser(description="streaming mel extraction")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = ap.parse_args().device

sr = 16000
cfg = vorbis_config(sr)
hop = cfg.stream_hop
signal = np.random.default_rng(0).normal(0, 0.1, hop * 100).astype(np.float32)

session = StreamingExtractor(cfg, device=dev)
chunks = np.split(signal, 10)  # 10 chunks of 10 hops each
streamed = [session.process(c) for c in chunks]
streamed.append(session.finalize())
streamed = torch.cat(streamed, dim=0)

batch = ss.mel_spectrogram(signal, sr, device=dev).T
print("streamed:", tuple(streamed.shape), "batch:", tuple(batch.shape))
print("max difference:", float((streamed - batch).abs().max()))
