"""Data-parallel corpus extraction on ``torch.distributed``: the (data, seq)
mesh, corpus moments, the halo exchange, the extraction step and the corpus
runner (:mod:`.runner`, imported on use)."""

from . import data, halo, mesh, stats  # noqa: F401
from .data import (  # noqa: F401
    extraction_step,
    extraction_step_packed,
    fetch_outputs,
    frame_counts_host,
    pack_signals,
    unpack_resample,
)
from .mesh import DATA_AXIS, SEQ_AXIS, data_sharding, make_mesh  # noqa: F401
from .stats import CorpusMoments, local_moments, psum_moments, tree_merge  # noqa: F401
