"""Launchers: ``serve`` (prefill a request batch, decode with caches),
``train`` (federated training of a registry arch), and the cells a rank of
a mesh runs: ``mesh`` (production and host meshes over the ranks),
``specs`` (meta stand-ins of every input with their specs) and ``steps``
(the train, prefill, decode and aggregation cells)."""
from repro_torch.launch import mesh, specs, steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.specs import input_specs

__all__ = ["mesh", "specs", "steps", "make_host_mesh", "make_production_mesh", "input_specs"]
