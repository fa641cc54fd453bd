"""Performance analysis: the three-term roofline (``roofline``) with the
H100's data-sheet peaks, the peaks measured on the device, and the
calibration of K3 against them. The JAX package's ``analysis.hlo`` parses
XLA's HLO text and has no counterpart here yet."""
from repro_torch.analysis import roofline

__all__ = ["roofline"]
