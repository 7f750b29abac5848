"""Distribution layer of the port: the sharding plan (the LM stack's spec
rules on a `DeviceMesh`, the COO stream partitioner, the shards'
placement), gradient compression, the single-process collective of the
sharded planned path, and that path itself (`repro_torch.dist.planned`).
Counterpart of `repro.dist`.  Gradient compression and the planned path
resolve on first use: `compression` reads the train step's trees, and
`planned` imports `repro_torch.kernels.ops`, which imports this package."""
import importlib

from .._lazy import lazy_attrs
from .collective import Replicas, reduce_partials
from .sharding import (
    NOPLAN,
    P,
    PartitionSpec,
    ShardingPlan,
    StreamPartition,
    batch_pspecs,
    batch_specs,
    make_plan,
    param_pspecs,
    partition_stream,
    shard,
    stream_imbalance,
    valid_spec,
)

__all__ = ["NOPLAN", "P", "PartitionSpec", "Replicas", "ShardingPlan", "StreamPartition", "batch_pspecs",
           "batch_specs", "compress_decompress", "dequantize_int8", "make_plan", "param_pspecs", "partition_stream",
           "quantize_int8", "reduce_partials", "shard", "stream_imbalance", "valid_spec"]

_compression = lazy_attrs(__name__, {name: ".compression"
                                     for name in ("compress_decompress", "dequantize_int8", "quantize_int8")})


def __getattr__(name):
    if name == "planned":
        return importlib.import_module(".planned", __name__)
    return _compression(name)
