"""Torch training-pipeline integration with the PyTorch port — the
train-in-Python story.

The same features at train time and at deploy time: the port's entry
points take tensors and return tensors on the chosen device, and its
``transforms`` are ``nn.Module``s for Dataset/DataLoader pipelines.  A
transform runs on its waveform's device, so the waveforms go to the device
first: on a CUDA device ``MFCC`` and ``MelSpectrogram`` run the CT mel
kernel.

Run: python examples_torch/torch_pipeline.py [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

import mfcc_rust_tpu_torch as ss
from mfcc_rust_tpu_torch import transforms
from mfcc_rust_tpu_torch.utils.device import resolve_device

ap = argparse.ArgumentParser(description="torch pipeline integration")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = resolve_device(ap.parse_args().device)  # raises without CUDA unless asked for the CPU

sr = 16000
rng = np.random.default_rng(0)

# --- functional: tensor in, tensor out -------------------------------------
wave = torch.from_numpy(rng.normal(0, 0.1, (sr * 3,)).astype(np.float32)).to(dev)
feats = ss.mfcc(wave, sr, device=dev)
print("mfcc:", tuple(feats.shape), feats.dtype)

# several features from one frontend pass
multi = ss.extract(wave, sr, which=("mfcc", "lmfe", "ssc"), device=dev)
print("extract:", {k: tuple(v.shape) for k, v in multi.items() if k != "mfe"})


# --- as a Dataset transform --------------------------------------------------
class ToneDataset(torch.utils.data.Dataset):
    """Toy dataset: random tones -> (librosa-semantics MFCC, label)."""

    def __init__(self, n, transform):
        self.freqs = rng.uniform(200, 2000, n)
        self.transform = transform

    def __len__(self):
        return len(self.freqs)

    def __getitem__(self, i):
        t = np.arange(22050, dtype=np.float32) / 22050
        wav = torch.from_numpy(0.5 * np.sin(2 * np.pi * self.freqs[i] * t)).to(dev)
        return self.transform(wav), float(self.freqs[i])


transform = transforms.MFCC(sr=22050, n_mfcc=13)
ds = ToneDataset(8, transform)
loader = torch.utils.data.DataLoader(ds, batch_size=4)
for batch, labels in loader:
    print("dataloader batch:", tuple(batch.shape), "labels:", [round(float(x)) for x in labels])

# the same extractor drops into an nn.Sequential preprocessing head
pipe = torch.nn.Sequential(transforms.MelSpectrogram(sr=22050, n_mels=64))
mel = pipe(torch.from_numpy(rng.normal(0, 0.1, (2, 22050)).astype(np.float32)).to(dev))
print("nn.Sequential mel:", tuple(mel.shape))
