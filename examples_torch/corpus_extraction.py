"""Corpus-scale extraction with the PyTorch port: device mesh + prefetch
loader + checkpointed corpus CMVN.

Runs on the one-rank mesh of this process; under ``torchrun`` (one process
a card, ``init_process_group("env://")`` first) the same code spans every
rank.  On a CUDA device each dispatched ``"mfcc"`` batch is one launch of
the fused MFCC kernel; the multi-feature pass runs the shared chunk-GEMM
frontend instead.

Run: python examples_torch/corpus_extraction.py [--device cuda|cpu]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import os
import tempfile

import numpy as np

from mfcc_rust_tpu_torch import FeatureConfig
from mfcc_rust_tpu_torch.parallel import make_mesh
from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner
from mfcc_rust_tpu_torch.runtime import write_wav

ap = argparse.ArgumentParser(description="corpus extraction")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
dev = ap.parse_args().device

# synthesize a tiny "corpus"
work = tempfile.mkdtemp()
rng = np.random.default_rng(0)
paths = []
for i in range(12):
    n = 16000 + 2000 * i
    clip = rng.normal(0, 0.1, n).astype(np.float32).clip(-1, 1)
    p = os.path.join(work, f"utt{i:03d}.wav")
    write_wav(p, clip, 16000)
    paths.append(p)

runner = CorpusRunner(
    paths,
    FeatureConfig(sample_rate=16000),
    make_mesh(device=dev),             # every rank of the group on the data axis
    batch_size=4,
    out_dir=os.path.join(work, "feats"),
    checkpoint_path=os.path.join(work, "state.npz"),
    on_batch=lambda info: print("  batch:", info),
)
moments = runner.run()

print("corpus frames:", int(moments.count))
print("corpus mean[:4]:", np.asarray(moments.mean)[:4])
print("throughput:", runner.meter.report()["audio_seconds_per_sec"], "audio-s/s")
print("features in:", os.path.join(work, "feats"))

# a second run resumes from the checkpoint and is a no-op
again = CorpusRunner(paths, FeatureConfig(sample_rate=16000), make_mesh(device=dev),
                     batch_size=4, checkpoint_path=os.path.join(work, "state.npz"))
again.run()
print("resume processed batches:", again.meter.batches, "(0 = resumed clean)")

# multi-feature: one frontend pass writes an .npz bundle per utterance and
# keeps per-feature corpus moments (same thing via the CLI:
#   python -m mfcc_rust_tpu_torch 'corpus/*.wav' --feature mfcc,lmfe,ssc --out-dir ...)
multi = CorpusRunner(
    paths,
    FeatureConfig(sample_rate=16000),
    make_mesh(device=dev),
    feature=("mfcc", "lmfe", "ssc", "energy"),
    batch_size=4,
    out_dir=os.path.join(work, "feats_multi"),
)
mmoments = multi.run()
print("multi-feature moments:",
      {k: tuple(np.asarray(v.mean).shape) for k, v in mmoments.items()})
bundle = np.load(os.path.join(work, "feats_multi", "utt000.npz"))
print("utt000 bundle:", {k: bundle[k].shape for k in bundle.files})
