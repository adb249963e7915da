"""ngt_tpu_torch — the PyTorch/CUDA port of ngt_tpu, an approximate-nearest-
neighbor index and query engine (a proximity-graph index after NGT).

The JAX package ``ngt_tpu`` stays the reference; this package mirrors its
module names, its on-disk index layout and its export stream, and runs on a
CUDA device (an NVIDIA H100) by default or on the CPU when asked
(``device="cpu"``).  It imports torch and numpy, never JAX.  Its
hand-written kernels live in ``csrc/`` and are built at first use by
``ops/_build.py``.  The interfaces: ``python -m ngt_tpu_torch`` (the CLI,
``cli.py``), ``ngt_tpu_torch.ngtpy`` (a drop-in ``ngtpy``),
``ngt_tpu_torch.base`` (the ``ngt.base`` surface) and
``ngt_tpu_torch.annb`` (ann-benchmarks adapters); ``parallel/`` shards an
index over a mesh of devices (``ShardedIndex``), merged with
torch.distributed collectives across processes; ``csrc/`` also holds the C
ABI (``native.build_capi``).
"""

from ngt_tpu_torch.properties import (  # noqa: F401
    DistanceType,
    ObjectType,
    IndexType,
    GraphType,
    SeedType,
    Property,
)
from ngt_tpu_torch.index import Index, create, open_index  # noqa: F401
from ngt_tpu_torch.utils import enable_log, disable_log  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, as ngt_tpu/__init__.py has them
    if name == "ShardedIndex":
        from ngt_tpu_torch.parallel.sharding import ShardedIndex

        return ShardedIndex
    if name == "IVFPQIndex":
        from ngt_tpu_torch.quant.ivfpq import IVFPQIndex

        return IVFPQIndex
    if name == "QuantizedGraphIndex":
        from ngt_tpu_torch.quant.qgraph import QuantizedGraphIndex

        return QuantizedGraphIndex
    raise AttributeError(f"module 'ngt_tpu_torch' has no attribute {name!r}")
