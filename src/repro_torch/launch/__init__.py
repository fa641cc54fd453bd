"""Launchers: ``serve`` (prefill a request batch, decode with caches) and
``train`` (federated training of a registry arch)."""
