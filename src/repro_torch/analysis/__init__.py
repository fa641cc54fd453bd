"""Performance analysis: the three-term roofline (``roofline``) with the
H100's data-sheet peaks, the peaks measured on the device, and the
calibration of K3 against them; and ``opcount``, the counterpart of the
JAX package's ``analysis.hlo``: the FLOPs, HBM bytes, collectives and
memory of a call, counted from the ops it dispatches (the dry run's
counter: ``launch.dryrun``)."""
from repro_torch.analysis import opcount, roofline

__all__ = ["opcount", "roofline"]
