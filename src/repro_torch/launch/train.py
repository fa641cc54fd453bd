"""Federated training launcher; the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --smoke \\
        --rounds 8 [--ckpt-dir DIR [--resume]] [--inject-failures] [--stragglers] \\
        [--device cpu]

Trains ``--arch`` (``--smoke``: its reduced config) federatedly on the
config's own topology (``cfg.fed``: edges x clients per edge, kappa1 capped
at 4 and kappa2 at 2) with SGD and exponential decay, over a token corpus
(or precomputed embeddings for the stub-frontend archs, ``embed_inputs``
false), and prints one line per round. Runs on ``cuda`` unless
``--device`` names another device; without a GPU and without ``--device``
it raises. The token corpus draws one f64 Dirichlet table of 8 x vocab x
vocab, as the JAX launcher does: at a full config's vocabulary that is tens
of GB of host memory (lm-100m's 32,768: 68.7 GB), so train a full-width
model through the spec path (``scenarios.get("lm_edge_niid",
overrides=["model.arch=lm-100m"])``, vocabulary ``data.vocab``).

``--ckpt-dir`` checkpoints every 4 rounds (keeping 2) and ``--resume``
restarts from its latest checkpoint; ``--inject-failures`` adds
``FailureSimulator(n, p_fail=0.1, seed=1)`` and ``--stragglers``
``StragglerModel(n, seed=2)``, as the JAX launcher does. Every arch of
the registry trains, among them xlstm-350m (mLSTM and sLSTM),
deepseek-v3-671b (MLA and MoE) and arctic-480b (MoE with a dense
residual); their loss adds the MoE aux loss to the cross-entropy.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke
from repro_torch.core import FedTopology, HierFAVGConfig
from repro_torch.data import FederatedBatcher, embedding_corpus, make_partition, token_corpus
from repro_torch.device import resolve_device
from repro_torch.fed import FailureSimulator, FederatedRunner, RunnerConfig, StragglerModel
from repro_torch.models import transformer
from repro_torch.optim import exponential_decay, sgd


def main(argv=None) -> FederatedRunner:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS) + ["lm-100m"])
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4, help="per-client batch")
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--stragglers", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke and args.arch in ARCH_IDS else get_config(args.arch)
    params = transformer.init_params(torch.Generator(device=device).manual_seed(0), cfg)
    topo = FedTopology(num_edges=cfg.fed.edges_per_pod, clients_per_edge=cfg.fed.clients_per_edge)
    hier = HierFAVGConfig(kappa1=min(cfg.fed.kappa1, 4), kappa2=min(cfg.fed.kappa2, 2))
    n = topo.num_clients
    rng = np.random.default_rng(0)

    if cfg.embed_inputs:
        corp = token_corpus(rng, num_sequences=max(128, n * 16), seq_len=args.seq_len,
                            vocab=cfg.vocab_size, num_classes=8)
        parts = make_partition("simple_niid", corp.labels, topo.num_edges, topo.clients_per_edge, rng)
        batcher = FederatedBatcher(
            {"tokens": corp.tokens}, parts, batch_size=args.batch, seed=0,
            batch_fn=lambda d: {"inputs": d["tokens"][..., :-1], "targets": d["tokens"][..., 1:]},
        )
    else:  # stub-frontend archs: precomputed embeddings
        emb, tgt, labels = embedding_corpus(
            rng, num_sequences=max(128, n * 16), seq_len=args.seq_len, d_model=cfg.d_model, num_classes=8,
        )
        tgt = np.clip(tgt, 0, cfg.vocab_size - 1)
        parts = make_partition("simple_niid", labels, topo.num_edges, topo.clients_per_edge, rng)
        batcher = FederatedBatcher({"inputs": emb, "targets": tgt}, parts, batch_size=args.batch, seed=0)

    runner = FederatedRunner(
        loss_fn=transformer.make_loss_fn(cfg),
        optimizer=sgd(exponential_decay(args.lr, 0.995, 50)),
        topology=topo,
        hier_config=hier,
        data_sizes=batcher.data_sizes,
        batcher=batcher,
        runner_config=RunnerConfig(num_rounds=args.rounds, checkpoint_every=4 if args.ckpt_dir else 0),
        checkpointer=CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None,
        failures=FailureSimulator(n, p_fail=0.1, seed=1) if args.inject_failures else None,
        stragglers=StragglerModel(n, seed=2) if args.stragglers else None,
        device=device,
    )
    rng = torch.Generator(device=device).manual_seed(1)
    if args.resume and args.ckpt_dir:
        state, start = runner.restore_or_init(rng, params)
        print(f"resumed at round {start}")
    else:
        state, start = runner.init(rng, params), 0
    runner.run(state, start_round=start)
    for h in runner.history:
        print(f"round {h.round:3d} step {h.step:4d} loss {h.loss:.4f} alive {h.mask_alive}")
    return runner


if __name__ == "__main__":
    main()
