"""Launchers: ``serve`` (prefill a request batch, decode with caches)."""
