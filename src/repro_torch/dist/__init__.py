"""Distribution layer of the port: the sharding plan (the LM stack's spec
rules on a `DeviceMesh`, the COO stream partitioner, the shards'
placement), gradient compression, the single-process collective of the
sharded planned path, and that path itself (`repro_torch.dist.planned`,
imported lazily here, since it pulls in the kernel layer).  Counterpart
of `repro.dist`."""
from .collective import Replicas, reduce_partials
from .sharding import NOPLAN, P, PartitionSpec, ShardingPlan, StreamPartition, make_plan, partition_stream, \
    stream_imbalance

__all__ = ["NOPLAN", "P", "PartitionSpec", "Replicas", "ShardingPlan", "StreamPartition", "make_plan",
           "partition_stream", "reduce_partials", "stream_imbalance"]


def __getattr__(name):
    # Lazy: repro_torch.dist.planned imports repro_torch.kernels.ops, which
    # imports this package.
    if name == "planned":
        import importlib

        return importlib.import_module(".planned", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
