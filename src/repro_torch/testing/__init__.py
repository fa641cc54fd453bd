"""Helpers for holding the port against the JAX reference (``parity``) and
the property-testing front-end (``property``: hypothesis when installed, a
seeded fallback otherwise)."""
from repro_torch.testing.property import HAVE_HYPOTHESIS, given, settings, st

__all__ = ["HAVE_HYPOTHESIS", "given", "settings", "st"]
