"""HierFAVG (client-edge-cloud hierarchical federated learning) in PyTorch.

The PyTorch/CUDA port of the JAX package ``repro``. The module layout
mirrors ``repro``'s, so each counterpart sits under the same path
(``repro_torch.fed.api`` is ``repro.fed.api``, and so on). The port never
imports ``jax`` or ``repro``; its tests import both and hold one against the
other.

Entry points (``ExperimentSpec.build`` / ``run_experiment`` and
``FederatedRunner``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without a device they raise.

    from repro_torch.fed import scenarios
    runner, state = scenarios.get("quickstart").run_experiment()
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    # torch is imported on first use, so a module that needs none of it
    # (``experiments.roofline_report``) starts without it
    if name == "resolve_device":
        from repro_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
