"""The paper's figure and table scripts on the port; the counterparts of
the JAX package's reproduction scripts, one module each, run as
``python -m repro_torch.experiments.<name>`` (``--device cpu`` for the
plain path; the card otherwise):

    table1_cost_model      Table I: the workloads' latency and energy constants
    fig4_convergence       Fig. 4: the two kappa guidelines, edge-IID and edge-NIID
    table2_latency_energy  Table II: T_alpha and E_alpha for the kappa sweeps
                           (IIa, IIb, IIc's int8 cloud hop, ``--sim`` replays)
    fig2_topologies        Fig. 2: cloud-based, edge-based and hierarchical FL
    compression_tradeoff   the kappa sweep under fp32, int8 and int8 with error feedback
    aggregation_scaling    the analytic per-level traffic of uniform and ragged trees
    round_time_sim         the replay simulator's parity, determinism, scenarios, association
    wallclock_curves       synchronous, deadline and buffered rounds on the event clock

``python -m repro_torch.experiments [--only NAME] [--device cpu]`` runs
them in turn. Each prints the same row keys as its JAX counterpart. The
stand-in problem is the synthetic 10-class data and a 16 -> 48 -> 10 MLP
(``common.bench_spec``), so a run's wall is host time: T and E are the
paper's cost model, not measured seconds.
"""
