"""Errors shared across the port's layers."""


def unported(feature: str, item) -> NotImplementedError:
    """The error for a configuration that needs a feature a later slice
    brings; names the ROADMAP.md item."""
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet (ROADMAP.md Queue 1 item {item} brings it)"
    )
