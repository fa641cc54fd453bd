"""Runnable examples of the port, the counterparts of the JAX package's
``examples/`` scripts, run as ``python -m repro_torch.examples.<name>``
(``--device cpu`` for the plain path; the card otherwise):

    quickstart          hierarchical FL from the ``quickstart`` scenario
    compare_topologies  cloud-based, edge-based and hierarchical FL, uniform,
                        ragged and three-level trees
    serve_lm            prefill a batch of prompts, then sample with the KV cache
    train_hier_lm       federated LM training from ``lm_edge_niid``, with
                        checkpoints and failure injection
"""
