"""The analytic traffic model of the aggregation schedule (``collectives``),
the rank mesh over torch.distributed ranks with its sharding rules, hints
and MoE's expert-parallel exchange (``sharding``), and the launcher of the
ranks (``launch``)."""
from repro_torch.dist import collectives, launch, sharding

__all__ = ["collectives", "launch", "sharding"]
