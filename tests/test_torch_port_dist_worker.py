"""Worker processes of the port's multi-rank tests (no tests here).

Run as ``python -m tests.test_torch_port_dist_worker <task> <rank> <world>
<work_dir> [args...]``: joins a gloo group of ``world`` ranks through a
FileStore in ``work_dir`` (60 s timeout on every collective), runs
``<task>`` and writes this rank's results to ``work_dir`` as npz.  The
module imports no JAX (the parent test does), and its input functions are
shared with the parent, which holds the results against the JAX package on
a mesh of the same layout.

Tasks:

* ``parallel <n_data> <n_seq>`` — every case of :data:`CASES` on a
  (n_data, n_seq) mesh: each rank saves its own blocks, rank 0 also the
  outputs gathered by ``fetch_outputs`` in the global layout;
* ``runner <n_data> <n_seq> <paths.json>`` — ``CorpusRunner`` on the mesh,
  rank 0 writing the outputs;
* ``host <paths.json>`` — one runner per process (``process_count`` =
  world, a one-rank mesh each), each writing its checkpoint;
* ``cli <local_world> <paths.json>`` — the port's ``cli.main`` as one
  process of a ``torchrun``-style world (``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``
  and ``LOCAL_RANK`` set): hosts of ``local_world`` ranks, each host's
  ``--cmvn-out`` its own file; the return code and what the process printed
  go to ``cli.rank<r>.json``;
* ``bench_scaling`` — ``bench_torch.scaling()`` in the world: what each
  rank printed and the lines it returned go to ``bench.rank<r>.json``;
* ``multihost <address>`` — ``parallel.mesh.initialize_multihost`` with the
  coordinator ``address`` (``host:port``) in place of the FileStore; the
  (rank, world) it returns and an all-reduce of the ranks go to
  ``multihost.rank<r>.json``.

:func:`faulty_rank` is a rank body for ``entry._spawn`` whose rank 1 raises.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import sys

import numpy as np

LAYOUTS = ((2, 2), (4, 1), (1, 4))


# ------------------------------------------------------------- inputs --
def quantize_pcm16(x):
    """Snap float32 samples onto the PCM16 grid (what a WAV decode yields)."""
    return (np.rint(x * 32768.0).clip(-32768, 32767).astype(np.float32) / np.float32(32768.0))


def ragged(seed: int, b: int, t: int, cut, dtype=np.float32, pcm=False):
    """(signals (b, t) zero past each length, lengths, clips) from a seed."""
    rng = np.random.default_rng(seed)
    lengths = np.array([max(t - c, 0) for c in cut][:b], dtype=np.int64)
    sigs = np.zeros((b, t), dtype)
    clips = []
    for i, n in enumerate(lengths):
        c = rng.normal(0, 0.1, n).astype(dtype)
        if pcm:
            c = quantize_pcm16(c.astype(np.float32)).astype(dtype)
        sigs[i, :n] = c
        clips.append(c)
    return sigs, lengths, clips


def inputs(name: str):
    """The seeded inputs of one case: (config kwargs, arrays)."""
    hop = vhop = 160  # the speechpy hop at 16 kHz; the vorbis one at 10 ms
    if name == "halo_left":
        return {"preset": "vorbis", "dtype": "float64"}, ragged(1, 4, 320 * 16, [0] * 4,
                                                                np.float64)
    if name == "pipeline":
        return {"preset": "speechpy"}, ragged(2, 8, hop * 100, [0] * 8)
    if name == "ragged":
        t = hop * 60
        return {"preset": "speechpy"}, ragged(3, 4, t, [0, 777, 3200, t - hop * 30])
    if name in ("packed", "packed_rows", "wire_f16"):
        t = hop * 60
        return {"preset": "speechpy"}, ragged(4, 4, t, [0, 777, 3200, t - hop * 30], pcm=True)
    if name == "packed_f32":
        return {"preset": "speechpy"}, ragged(5, 4, hop * 40, [0, 1234, 99, 3001])
    if name in ("multi", "packed_multi", "ssc"):
        t = hop * 80
        return {"preset": "speechpy"}, ragged(6, 4, t, [0, 777, 3200, t - hop * 40], pcm=True)
    if name == "melspec":
        return {"preset": "vorbis_10ms"}, ragged(7, 4, vhop * 64, [0] * 4)
    if name == "hop_misaligned":
        return ({"preset": "speechpy", "dtype": "float64", "frame_length": 0.025},
                ragged(8, 4, hop * 52, [0, 1234, 5, 4000], np.float64))
    if name == "resample":
        return {}, ragged(9, 4, 8192, [0, 999, 17, 4000], pcm=True)
    raise KeyError(name)


def config(P, kw: dict):
    """The case's FeatureConfig of package ``P`` (either package's
    top-level module)."""
    kw = dict(kw)
    preset = kw.pop("preset", "speechpy")
    if preset == "vorbis":
        return P.vorbis_config(16000, **kw)
    if preset == "vorbis_10ms":
        return P.vorbis_config(16000, frame_length=0.01, **kw)
    return P.speechpy_config(16000, **kw)


# -------------------------------------------------------------- cases --
def _np(tree):
    import torch
    import torch.utils._pytree as pytree

    return pytree.tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x),
        tree)


def _save_tree(out: dict, prefix: str, tree):
    """Flatten a (nested dict/tuple) result tree into npz keys
    ``prefix/<key or index>/...``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _save_tree(out, f"{prefix}/{k}", v)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _save_tree(out, f"{prefix}/{i}", v)
    else:
        out[prefix] = np.asarray(tree)


def run_case(name: str, mesh):
    """One case on this rank: {npz key: array}.  Keys ``l/...`` are this
    rank's blocks, ``g/...`` (rank 0 only) the gathered global outputs."""
    import torch

    import mfcc_rust_tpu_torch as P
    from mfcc_rust_tpu_torch.parallel import (extraction_step, extraction_step_packed,
                                              fetch_outputs, frame_counts_host, halo,
                                              pack_signals, unpack_resample)
    from mfcc_rust_tpu_torch.parallel.mesh import data_seq_sharding

    kw, (sigs, lengths, clips) = inputs(name)
    cfg = config(P, kw)
    res = {}

    def both(tag, out):
        _save_tree(res, f"l/{tag}", _np(out))
        g = fetch_outputs([out], mesh)
        if mesh.is_root:
            _save_tree(res, f"g/{tag}", g[0])

    if name == "halo_left":
        local = torch.from_numpy(np.ascontiguousarray(data_seq_sharding(mesh).block(sigs)))
        power = halo.sharded_stft_vorbis_power(local, cfg, mesh)
        both("power", (power, torch.ones(power.shape[:2], dtype=torch.bool),
                       torch.zeros(())))
    elif name in ("pipeline", "ragged", "hop_misaligned"):
        both("step", extraction_step(sigs, lengths, cfg, mesh))
    elif name == "melspec":
        both("step", extraction_step(sigs, lengths, cfg, mesh, "melspec"))
        flat, offs, lens = pack_signals(clips, 4)
        both("packed", extraction_step_packed(flat, offs, lens, sigs.shape[1], cfg, mesh,
                                              "melspec"))
        counts = frame_counts_host(lens, cfg, "melspec")
        both("rows", extraction_step_packed(flat, offs, lens, sigs.shape[1], cfg, mesh,
                                            "melspec", frame_counts=counts))
    elif name == "ssc":
        both("step", extraction_step(sigs, lengths, cfg, mesh, "ssc"))
    elif name == "multi":
        heads = ("mfcc", "lmfe", "mfe", "ssc", "energy")
        both("step", extraction_step(sigs, lengths, cfg, mesh, heads))
        for h in ("mfcc", "lmfe", "ssc"):
            both(h, extraction_step(sigs, lengths, cfg, mesh, h))
        for bad in (("mfcc", "melspec"), ("mfcc", "plp")):
            try:
                extraction_step(sigs, lengths, cfg, mesh, bad)
            except ValueError as e:
                res["err/" + bad[1]] = np.array(str(e))
    elif name in ("packed", "packed_f32", "packed_multi"):
        b_pad = 8 if name == "packed" else 4
        which = ("mfcc", "lmfe", "energy") if name == "packed_multi" else "mfcc"
        flat, offs, lens = pack_signals(clips, b_pad)
        res["flat_dtype"] = np.array(str(flat.dtype))
        both("step", extraction_step_packed(flat, offs, lens, sigs.shape[1], cfg, mesh, which))
    elif name in ("packed_rows", "wire_f16"):
        flat, offs, lens = pack_signals(clips, 8)
        counts = frame_counts_host(lens, cfg, "mfcc")
        t = sigs.shape[1]
        both("rows", extraction_step_packed(flat, offs, lens, t, cfg, mesh, "mfcc",
                                            frame_counts=counts))
        if name == "wire_f16":
            both("f16", extraction_step_packed(flat, offs, lens, t, cfg, mesh, "mfcc",
                                               frame_counts=counts, wire_dtype="float16"))
            which = ("mfcc", "mfe")
            both("m32", extraction_step_packed(flat, offs, lens, t, cfg, mesh, which,
                                               frame_counts=counts))
            both("m16", extraction_step_packed(flat, offs, lens, t, cfg, mesh, which,
                                               frame_counts=counts, wire_dtype="float16"))
        else:
            pad = np.zeros((8, t), np.float32)
            pad[:4] = sigs
            which = ("mfcc", "mfe", "energy")
            both("multi_rows", extraction_step(pad, lens, cfg, mesh, which,
                                               frame_counts=counts))
    elif name == "resample":
        flat, offs, lens = pack_signals(clips, 4)
        sig = unpack_resample(flat, offs, lens, sigs.shape[1], 2, 1, mesh)
        _save_tree(res, "l/sig", _np(sig))
    else:
        raise KeyError(name)
    return res


CASES = ("halo_left", "pipeline", "ragged", "melspec", "ssc", "multi", "packed",
         "packed_f32", "packed_multi", "hop_misaligned", "packed_rows", "wire_f16",
         "resample")


# ---------------------------------------------------------------- main --
def _init(rank: int, world: int, work: str):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(work, "filestore"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))


def faulty_rank(world: int, device) -> None:
    """A rank body for ``mfcc_rust_tpu_torch.entry._spawn``: rank 1 raises
    once the group is up, rank 0 waits in a barrier for it."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("fault injected on rank 1")
    dist.barrier()


def _multihost(rank: int, world: int, work: str, address: str) -> None:
    import torch
    import torch.distributed as dist

    from mfcc_rust_tpu_torch.parallel.mesh import initialize_multihost

    torch.set_num_threads(1)
    got = initialize_multihost(address, world, rank, device="cpu")
    total = torch.tensor([rank + 1.0])
    dist.all_reduce(total)
    with open(os.path.join(work, f"multihost.rank{rank}.json"), "w") as f:
        json.dump({"rank_world": list(got), "sum": float(total)}, f)
    dist.barrier()
    dist.destroy_process_group()


def main(argv) -> None:
    task, rank, world, work = argv[0], int(argv[1]), int(argv[2]), argv[3]
    if task == "multihost":
        _multihost(rank, world, work, argv[4])
        return
    _init(rank, world, work)
    import torch.distributed as dist

    from mfcc_rust_tpu_torch import speechpy_config
    from mfcc_rust_tpu_torch.parallel import make_mesh

    if task == "parallel":
        mesh = make_mesh(int(argv[4]), int(argv[5]), device="cpu")
        for name in CASES:
            np.savez(os.path.join(work, f"{name}.rank{rank}.npz"), **run_case(name, mesh))
    elif task == "runner":
        from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner

        mesh = make_mesh(int(argv[4]), int(argv[5]), device="cpu")
        paths = json.load(open(argv[6]))
        calls = []
        runner = CorpusRunner(paths, speechpy_config(16000), mesh, batch_size=4,
                              out_dir=os.path.join(work, "out"), on_batch=calls.append,
                              checkpoint_path=os.path.join(work, "ck.npz"))
        m = runner.run()
        np.savez(os.path.join(work, f"runner.rank{rank}.npz"), count=m.count, mean=m.mean,
                 m2=m.m2, batches=len(calls), coords=np.array(mesh.coords))
    elif task == "host":
        # one runner per process on its own one-rank mesh: the group only
        # lines the processes up; no collective crosses runners
        from mfcc_rust_tpu_torch.parallel.runner import CorpusRunner

        paths = json.load(open(argv[4]))
        try:  # a mesh across the runners is refused
            CorpusRunner(paths, speechpy_config(16000), make_mesh(device="cpu"),
                         process_index=rank, process_count=world)
        except ValueError:
            pass
        else:
            raise AssertionError("a mesh spanning two runners was accepted")
        dist.barrier()
        dist.destroy_process_group()
        mesh = make_mesh(1, 1, device="cpu")
        CorpusRunner(paths, speechpy_config(16000), mesh, batch_size=2,
                     out_dir=os.path.join(work, "out"),
                     checkpoint_path=os.path.join(work, f"host{rank}.npz"),
                     process_index=rank, process_count=world).run()
        return
    elif task == "cli":
        # the CLI joins the group already made here, makes the hosts'
        # groups and destroys the group when it is done
        from mfcc_rust_tpu_torch import cli

        local = int(argv[4])
        paths = json.load(open(argv[5]))
        os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_WORLD_SIZE=str(local),
                          LOCAL_RANK=str(rank % local))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main([*paths, "--out-dir", os.path.join(work, "out"), "--batch-size", "4",
                           "--cmvn-out", os.path.join(work, f"cmvn.host{rank // local}.npz"),
                           "--device", "cpu", "--quiet"])
        with open(os.path.join(work, f"cli.rank{rank}.json"), "w") as f:
            json.dump({"rc": rc, "stdout": out.getvalue()}, f)
        return
    elif task == "bench_scaling":
        # bench_torch.scaling() on this CPU world: harness lines only
        import bench_torch

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            lines = bench_torch.scaling()
        with open(os.path.join(work, f"bench.rank{rank}.json"), "w") as f:
            json.dump({"stdout": out.getvalue(), "lines": lines}, f)
    else:
        raise KeyError(task)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
