"""The analytic traffic model of the aggregation schedule (``collectives``),
the client mesh over torch.distributed ranks (``sharding``) and its
launcher (``launch``)."""
