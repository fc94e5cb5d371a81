"""Per-shape CUDA-graph replay: the port's counterpart of the JAX package's
compiled-call layer (``api._jitted``, ``_jitted_extract`` and
``Pipeline._jit``, which compile one program per function, config and input
shape, the Pallas kernel inside).

:data:`cache` holds up to :data:`MAXSIZE` graphs, least recently used out
first, as ``api._jitted``'s ``lru_cache(16)``.  A graph's key is the
caller's (the function and its config, plus whatever else fixes the launch
sequence) with the input's shape, dtype and device.  :meth:`GraphCache.run`:

* first call of a key: the caller's ``fill`` writes the input into a new
  static input; one eager warm-up of the function on the cache's stream
  builds every tensor cache, the kernels' launch plans and cuBLAS's state;
  then the function is captured on that stream.  The warm-up's output is
  the call's result, so a first call launches each kernel as often as an
  eager call does.  The graph keeps every tensor-cache value the capture
  read (:func:`..constants.holding`): it reads them at their addresses on
  every replay, whatever the caches evict later;
* every later call: on the cache's stream of the device, ordered after the
  caller's stream and before the caller's later work, ``fill`` writes the
  input into the static input, the graph replays (the glue, K1 or K2, the
  heads, in one graph launch), and the static outputs are copied into
  fresh tensors of the caller's stream: JAX returns fresh arrays, and a
  result must survive the next call.  One stream per device puts the calls
  of every thread and stream in one order on the device, as one lock does
  on the host.

A capture that fails raises; nothing falls back to an eager call.  The
callers (``api``, ``models.pipelines.Pipeline``, the streaming sessions)
run eagerly only where :func:`runs_eagerly` says the semantics need it.

Streaming sessions (``models.incremental.IncrementalFrontend``, the
recompute path of ``models.pipelines.StreamingFeatures`` and
``models.pipelines.StreamingExtractor``) each own a :class:`GraphCache`, as
the JAX sessions each own their ``jax.jit``: a stream neither evicts the
``api`` graphs nor is evicted by them.  A session's graphs never run at
once, so they share one memory pool (``share_pool=True``).  A graph may
read and write caller-owned ``state`` beside its static input (the carry
of a stream): tensors allocated once outside any graph pool, which the
function updates in place and the caller resets in place (``zero_``); the
graph reads and writes them at their addresses, so a replay carries the
state with no host work.  The first call's warm-up is the real first step
and the capture executes nothing, so the first call advances the state
once.  A call whose state tensors are not the ones the graph captured
raises: a replay would read the old ones.

The corpus steps (``parallel.data``: the packed and padded extraction steps
and the unpack-and-resample pass) own one :class:`GraphCache` too, sized to
the corpus's (batch, bucket) grid.  Their static input is a tuple (the flat
sample buffer at the key's capacity and one int64 header of offsets,
lengths and frame offsets): ``shape`` and ``dtype`` are then tuples of
them, ``fill`` writes each.  A packed-output step's rows are as many as its
batch has valid frames, which the key does not fix: the graph writes a
fixed row capacity and ``trim`` cuts its outputs to the batch's rows before
the copy-out.

Spans (:func:`.profiling.span`): ``graphs.run`` around a call, and inside
it ``graphs.capture`` (a first call: fill, warm-up and recording) or
``graphs.fill``, ``graphs.replay`` and ``graphs.copy_out``; they record
only while :func:`.profiling.spans` is open or a profiler runs.

Launch counts: each kernel wrapper counts its launches (``.launches``), and
K2 its launches by path too.  A capture runs the wrappers but launches
nothing, so its counts are taken back and kept with the graph; each replay
adds them, as many as the device performs.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import warnings
from typing import Callable

import torch

from ..constants import _capturing, _tracing, holding
from .profiling import recording, span

MAXSIZE = 16

_enabled = True

# One stream a device and one lock for every cache: a capture records all
# work on its stream, so no other cache may use that stream meanwhile.
_streams: dict = {}
_lock = threading.RLock()


def runs_eagerly(x: torch.Tensor, device: torch.device) -> bool:
    """Whether a call on ``x`` computing on ``device`` runs eagerly instead
    of through a graph: on the CPU; when ``x`` requires a gradient (autograd
    records the kernels' ``autograd.Function``s); inside a trace, which
    records the function itself (``torch.export`` of a pipeline), or inside
    an enclosing capture, which records the eager launches (as ``jax.jit``
    inlines into an enclosing trace); and inside :func:`disabled`."""
    return (device.type != "cuda" or not _enabled
            or (x.requires_grad and torch.is_grad_enabled())
            or _capturing() or _tracing())


@contextlib.contextmanager
def disabled():
    """Inside, every call runs eagerly: the eager calls that a measurement
    holds the replays against."""
    global _enabled
    saved, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = saved


_wrappers: list = []


def _kernels() -> tuple:
    """The kernel wrappers whose launches a graph counts (K1, K2, the
    speechpy edge sums, the speechpy heads, the Whisper finish, the NeMo
    prologue and finish), then K2's launches by path (``ct_mel``'s
    ``path_launches``, 1, 2, 3) and those that staged the reflect pad
    (``reflect_launches``): the modules' own, whatever a check puts in
    their place meanwhile (it does so under :func:`disabled`)."""
    if not _wrappers:
        from ..ops.cuda import (ct_mel, nemo_logmel, speechpy_edges, speechpy_heads,
                                speechpy_mfcc, whisper_logmel)

        _wrappers.extend((speechpy_mfcc.mfcc_fused, ct_mel.ct_mel, speechpy_edges.edge_sums,
                          speechpy_heads.heads, whisper_logmel.whisper_logmel,
                          nemo_logmel.nemo_prologue, nemo_logmel.nemo_finish,
                          *ct_mel.path_launches.values(), ct_mel.reflect_launches))
    return tuple(_wrappers)


def _counts(kernels) -> tuple:
    return tuple(k.launches for k in kernels)


def _tree(fn, out):
    """``fn`` on every tensor of a tensor, tuple, list or dict of them."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, dict):
        return {k: _tree(fn, v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        items = [_tree(fn, v) for v in out]
        return type(out)(*items) if hasattr(out, "_fields") else type(out)(items)
    raise TypeError(f"a graphed function returns tensors, got {type(out).__name__}")


def _copy_tree(dst, src) -> None:
    """Copy every tensor of ``src`` into its place in ``dst`` (trees alike)."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_tree(dst[k], src[k])
    else:
        for d, s in zip(dst, src):
            _copy_tree(d, s)


def _tensors(value):
    """The tensors of a tensor-cache value (tensors in tuples, lists and
    dicts, beside other values)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


def _pool_bytes(pool) -> int:
    """Bytes of device memory a graph pool holds."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if s["segment_pool_id"] == pool)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _empty(shape, dtype, device):
    """A static input: one tensor, or a tuple of them where ``dtype`` is a
    tuple (``shape`` then a tuple of shapes)."""
    if isinstance(dtype, tuple):
        return tuple(torch.empty(tuple(s), dtype=d, device=device) for s, d in zip(shape, dtype))
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _device_of(static) -> torch.device:
    return next(_tensors(static)).device


class _Graph:
    """One captured call: its static input and outputs, the state it reads
    and writes, the launches of one replay per kernel, and what must live
    as long as the graph reads it (a module's buffers, the tensor-cache
    values of the capture)."""

    __slots__ = ("graph", "static", "out", "state", "launches", "keep", "capture_s")

    def __init__(self, graph, static, out, state, launches, keep, capture_s):
        self.graph, self.static, self.out, self.state = graph, static, out, state
        self.launches, self.keep, self.capture_s = launches, keep, capture_s

    def pool_bytes(self) -> int:
        """Bytes of device memory the graph's pool holds (shared with the
        other graphs of a ``share_pool`` cache)."""
        return _pool_bytes(self.graph.pool())


class GraphCache:
    """An LRU cache of captured calls; see the module's docstring."""

    def __init__(self, maxsize: int = MAXSIZE, share_pool: bool = False):
        self.maxsize = maxsize
        self._graphs: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
        self._share_pool = share_pool
        self._pool = None  # the one pool of a share_pool cache, made at its first capture
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0  # every capture's recording, evicted graphs' too

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        """Drop every graph; its pool is freed once nothing holds a tensor
        of it (``torch.cuda.empty_cache`` then returns it to the device)."""
        with _lock:
            self._graphs.clear()

    @staticmethod
    def key(key: tuple, shape, dtype: torch.dtype, device: torch.device) -> tuple:
        """The full key of a call: the caller's, the input's shape, dtype and
        device (with its index), and inference mode (its tensors cannot be
        written outside it)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        shape = tuple(map(tuple, shape)) if isinstance(dtype, tuple) else tuple(shape)
        return key, shape, dtype, device, torch.is_inference_mode_enabled()

    def run(self, key: tuple, fn: Callable, shape, dtype: torch.dtype,
            device: torch.device, fill: Callable[[torch.Tensor], None], keep=None,
            state: tuple = (), trim: Callable = None):
        """``fn(static, *state)`` for the input that ``fill`` writes into the
        static input (``shape``, ``dtype`` on ``device``; tuples of them for
        a tuple of static inputs): captured at the first call of the key,
        replayed at every later one.  ``state``: the caller's tensors that
        ``fn`` reads and updates in place, the same tensors at every call of
        the key.  ``keep`` lives as long as the graph (what ``fn`` reads
        besides the static input and the state).  ``trim``: the part of the
        outputs this call returns (views of them), for outputs larger than
        the call's result."""
        with span("graphs.run"):
            full = self.key(key, shape, dtype, device)
            with _lock:  # one call at a time writes a static input and replays
                g = self._graphs.get(full)
                if g is None:
                    with span("graphs.capture"):
                        static = _empty(shape, dtype, full[3])
                        fill(static)
                        out, g = self._capture(fn, static, keep, tuple(state))
                    self._graphs[full] = g
                    self.captures += 1
                    self.capture_seconds += g.capture_s
                    if len(self._graphs) > self.maxsize:
                        self._graphs.popitem(last=False)
                    return out if trim is None else trim(out)
                if len(state) != len(g.state) or any(a is not b for a, b in zip(state, g.state)):
                    raise RuntimeError("a graph's state was rebound: it reads and writes the "
                                       "tensors it captured, so update them in place")
                self._graphs.move_to_end(full)
                out = self._replay(g, fill, trim)
                for k, n in zip(_kernels(), g.launches):
                    if n:
                        k.launches += n
                self.replays += 1
                return out

    def _replay(self, g: _Graph, fill: Callable[[torch.Tensor], None], trim=None):
        """Fill, replay and copy out (the ``trim`` of the outputs) on the
        cache's stream; the copies are the caller's stream's tensors."""
        view = g.out if trim is None else trim(g.out)
        out = _tree(torch.empty_like, view)
        with self._on_cache_stream(_device_of(g.static)):
            if recording():
                with span("graphs.fill"):
                    fill(g.static)
                with span("graphs.replay"):
                    g.graph.replay()
                with span("graphs.copy_out"):
                    _copy_tree(out, view)
            else:  # one test a call: three idle spans would cost it ~1.8 µs of host time
                fill(g.static)
                g.graph.replay()
                _copy_tree(out, view)
        return out

    @contextlib.contextmanager
    def _on_cache_stream(self, device: torch.device):
        """Inside, work goes to the cache's stream of ``device`` after the
        caller's stream's work so far; the caller's stream waits for it on
        the way out."""
        main = torch.cuda.current_stream(device)
        side = _streams.get(device)
        if side is None:
            side = _streams[device] = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            yield side
        main.wait_stream(side)

    def _warm_up(self, fn: Callable, static: torch.Tensor, state: tuple):
        """One eager call of ``fn`` on the cache's stream, which builds what
        a capture may not (tensor caches, launch plans, cuBLAS's workspace
        for that stream) and advances the state; its output, usable on the
        caller's stream.  The tensor-cache values it builds are marked as
        used on the caller's stream too, so that their memory is not reused
        before the caller's work on them is done."""
        device = _device_of(static)
        main = torch.cuda.current_stream(device)
        with holding() as held, self._on_cache_stream(device):
            out = fn(static, *state)
        for t in (t for v in held for t in _tensors(v) if t.is_cuda):
            t.record_stream(main)
        _tree(lambda t: t.record_stream(main), out)
        return out

    def _record(self, fn: Callable, static: torch.Tensor, state: tuple):
        """(the graph of ``fn`` on ``static`` and ``state``, its static
        outputs).  Recording executes nothing, so the state is not
        advanced."""
        graph = torch.cuda.CUDAGraph()
        if self._share_pool and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        with warnings.catch_warnings():
            # a call with no work (no frames) captures an empty graph
            warnings.filterwarnings("ignore", message="The CUDA Graph is empty")
            with torch.cuda.graph(graph, pool=self._pool, stream=_streams[_device_of(static)],
                                  capture_error_mode="thread_local"):
                out = fn(static, *state)
        return graph, out

    def _capture(self, fn: Callable, static: torch.Tensor, keep, state: tuple):
        """(the warm-up's output, the captured call).  One warm-up, then the
        recording: a second warm-up would step a stream's state twice.  The
        launches the capture counted are taken back and kept with the graph,
        and so are the tensor-cache values it read; a capture that fails
        raises with the counts as they were."""
        out = self._warm_up(fn, static, state)
        kernels = _kernels()
        before = _counts(kernels)
        t0 = time.perf_counter()
        try:
            with holding() as held:
                graph, static_out = self._record(fn, static, state)
        finally:
            launches = tuple(a - b for a, b in zip(_counts(kernels), before))
            for k, n in zip(kernels, launches):
                if n:
                    k.launches -= n
        return out, _Graph(graph, static, static_out, state, launches, (keep, held),
                           time.perf_counter() - t0)

    def stats(self) -> dict:
        """Captures, replays, graphs held, and the device bytes they hold:
        their pools (a shared pool once), their static inputs and their
        state (``bytes``), on the card."""
        graphs = self._graphs.values()
        pools = sum(_pool_bytes(p) for p in {g.graph.pool() for g in graphs})
        static = sum(_nbytes(t) for g in graphs for t in _tensors(g.static))
        state = sum(_nbytes(t) for t in {id(t): t for g in graphs for t in g.state}.values())
        return {"captures": self.captures, "replays": self.replays, "graphs": len(self),
                "pool_bytes": pools, "static_bytes": static, "state_bytes": state,
                "bytes": pools + static + state,
                "capture_s": [g.capture_s for g in graphs]}


cache = GraphCache()
