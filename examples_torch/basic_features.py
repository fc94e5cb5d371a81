"""Basic feature extraction with the PyTorch port — the speechpy-compatible
surface.

Run: python examples_torch/basic_features.py [--device cuda|cpu]

On a CUDA device ``mfcc`` runs the fused MFCC kernel and the librosa mel
and MFCC run the CT mel kernel; on the CPU their plain PyTorch versions run.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

import mfcc_rust_tpu_torch as ss

ap = argparse.ArgumentParser(description="basic feature extraction")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = ap.parse_args().device

sr = 16000
t = np.arange(sr * 2) / sr
signal = (0.6 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)

# MFCC with speechpy defaults (20 ms frames, 10 ms hop, 40 mels, 13 cepstra)
mfcc = ss.mfcc(signal, sr, device=dev)
print("mfcc:", tuple(mfcc.shape))

# mel filterbank energies + per-frame energies
fbe, energy = ss.mfe(signal, sr, device=dev)
print("mfe:", tuple(fbe.shape), "energy:", tuple(energy.shape))

# log-FBE, spectral subband centroids
print("lmfe:", tuple(ss.lmfe(signal, sr, device=dev).shape))
print("ssc:", tuple(ss.ssc(signal, sr, device=dev).shape))

# reference-parity mel spectrogram (vorbis streaming STFT path); 2-D input
# dispatches to the batched variant
print("mel 1-D:", tuple(ss.mel_spectrogram(signal, sr, device=dev).shape))
print("mel 2-D:", tuple(ss.mel_spectrogram(np.stack([signal, signal]), sr, device=dev).shape))

# post-processing: deltas and CMVN
cube = ss.extract_derivative_feature(mfcc, device=dev)
print("feature cube:", tuple(cube.shape))
norm = ss.cmvn(mfcc, variance_normalization=True, device=dev)
print("cmvn mean ~0:", float(norm.mean(0).abs().max()))

# librosa-compatible family
y = np.random.default_rng(0).normal(0, 0.1, 22050).astype(np.float32)
print("librosa mel:", tuple(ss.mel_spectrogram_librosa(y, 22050, device=dev).shape))
print("librosa mfcc:", tuple(ss.mfcc_librosa(y, 22050, device=dev).shape))

# librosa-style deltas (Savitzky-Golay) and resampling on the device
mf = ss.mfcc_librosa(y, 22050, device=dev)
print("librosa delta:", tuple(ss.delta_librosa(mf, device=dev).shape))
print("resampled 22.05k -> 16k:", tuple(ss.resample(y, 22050, 16000, device=dev).shape))
