"""Distribution layer of the port: the COO stream partitioner, the shards'
placement (`ShardingPlan`), the single-process collective of the sharded
planned path, and that path itself (`repro_torch.dist.planned`, imported
lazily here, since it pulls in the kernel layer).  Counterpart of the
decomposition half of `repro.dist`; gradient compression and the LM
stack's spec rules come with the LM stack."""
from .collective import Replicas, reduce_partials
from .sharding import ShardingPlan, StreamPartition, partition_stream, stream_imbalance

__all__ = ["Replicas", "ShardingPlan", "StreamPartition", "partition_stream", "reduce_partials",
           "stream_imbalance"]


def __getattr__(name):
    # Lazy: repro_torch.dist.planned imports repro_torch.kernels.ops, which
    # imports this package.
    if name == "planned":
        import importlib

        return importlib.import_module(".planned", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
