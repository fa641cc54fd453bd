"""The paper's own experiment configurations (Section IV-A).

50 clients / 5 edge servers / 1 cloud; mini-batch SGD batch 20;
MNIST: lr 0.01, exp decay 0.995/epoch; CIFAR-10: lr 0.1, decay 0.992/epoch;
no momentum. Offline stand-in datasets come from data.synthetic (same
10-class structure, same partition protocols).

Also defines lm_100m — the ~100M-param LM used by the end-to-end training
example (deliverable (b)): a granite-3-family dense transformer scaled to
~100M params.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig, FedPlan


@dataclasses.dataclass(frozen=True)
class PaperFLConfig:
    name: str
    num_clients: int = 50
    num_edges: int = 5
    batch_size: int = 20
    lr: float = 0.01
    lr_decay: float = 0.995  # per epoch
    kappa1: int = 60
    kappa2: int = 1

    @property
    def clients_per_edge(self) -> int:
        return self.num_clients // self.num_edges

    def hierarchy(self):
        """The paper topology as a (uniform two-level) HierarchySpec."""
        from repro_torch.core.hierarchy import HierarchySpec

        return HierarchySpec.uniform(self.num_edges, self.clients_per_edge)


MNIST = PaperFLConfig(name="paper_mnist", lr=0.01, lr_decay=0.995)
CIFAR10 = PaperFLConfig(name="paper_cifar10", lr=0.1, lr_decay=0.992)

# Table II κ sweeps
MNIST_KAPPAS = ((60, 1), (30, 2), (15, 4), (6, 10))
CIFAR_KAPPAS = ((50, 1), (25, 2), (10, 5), (5, 10))

# Beyond-paper topologies for the ragged-hierarchy engine: the same 50
# clients under (a) uneven edge fan-out (metro edges serve more clients
# than rural ones) and (b) a three-level client/edge/region/cloud tree.
RAGGED_EDGE_FANOUT = ((16, 12, 10, 7, 5), (5,))
THREE_LEVEL_FANOUT = ((16, 12, 10, 7, 5), (2, 3), (2,))
THREE_LEVEL_KAPPAS = (15, 2, 2)  # ≈ the paper's (15, 4) budget, split over 3 hops


LM_100M = ArchConfig(
    name="lm-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    d_ff=2048,
    vocab_size=32768,
    param_dtype="float32",
    compute_dtype="float32",
    remat="none",
    attn_chunk=0,
    microbatch=4,
    fed=FedPlan(layout="stacked", edges_per_pod=4, clients_per_edge=4, kappa1=8, kappa2=4),
    source="framework-native 100M example",
)
