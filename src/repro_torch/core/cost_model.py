"""Latency / energy cost model (Section IV, Eq. 4-5, Tables I-II).

Copy-port of the wireless part of ``repro.core.cost_model`` (pure
Python): ``RoundRecord.sim_time_s`` / ``sim_energy_j`` read it.

    T_comp = c*D / f                 E_comp = (alpha/2) * c * D * f^2
    T_comm = M / (B * log2(1 + h*p/sigma))     E_comm = p * T_comm

with the cloud hop taking ``cloud_latency_mult`` (=10) x the edge latency.
Client energy covers local compute and the client radio uplink only.

Per cloud interval (kappa1*kappa2 local steps):
    time   = kappa1*kappa2*T_comp + kappa2*T_comm_edge + (mult-1)*T_comm_edge
    energy = kappa1*kappa2*E_comp + kappa2*E_comm_edge
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class WirelessParams:
    """Table I / Section IV-A constants."""

    bandwidth_hz: float = 1e6
    channel_gain: float = 1e-8
    tx_power_w: float = 0.5
    noise_w: float = 1e-10
    cycles_per_bit: float = 20.0
    cpu_freq_hz: float = 1e9
    capacitance: float = 2e-28
    cloud_latency_mult: float = 10.0

    def t_comp(self, d_bits: float) -> float:
        return self.cycles_per_bit * d_bits / self.cpu_freq_hz

    def e_comp(self, d_bits: float) -> float:
        return 0.5 * self.capacitance * self.cycles_per_bit * d_bits * self.cpu_freq_hz ** 2

    def spectral_rate(self) -> float:
        snr = self.channel_gain * self.tx_power_w / self.noise_w
        return self.bandwidth_hz * math.log2(1.0 + snr)

    def t_comm(self, m_bits: float) -> float:
        return m_bits / self.spectral_rate()

    def e_comm(self, m_bits: float) -> float:
        return self.tx_power_w * self.t_comm(m_bits)


@dataclasses.dataclass(frozen=True)
class WorkloadCosts:
    """Per-local-iteration / per-upload costs for one workload (Table I row)."""

    t_comp: float
    t_comm_edge: float
    e_comp: float
    e_comm_edge: float
    cloud_latency_mult: float = 10.0

    @property
    def t_comm_cloud(self) -> float:
        return self.cloud_latency_mult * self.t_comm_edge

    def with_bits(self, edge_bits_per_param: float = 32.0, cloud_bits_per_param: float = 32.0) -> "WorkloadCosts":
        """Costs under a compressed transport: uploads carry bits/32 of the
        fp32 payload per hop. Edge comm time and energy scale by the edge
        ratio; ``cloud_latency_mult`` is rescaled by the cloud/edge ratio,
        so ``t_comm_cloud`` becomes ``mult * (cloud_bits/32) * t_comm_edge``
        of the fp32 costs. Compute costs are unchanged."""
        if edge_bits_per_param <= 0 or cloud_bits_per_param <= 0:
            raise ValueError("bits per parameter must be positive")
        es = edge_bits_per_param / 32.0
        cs = cloud_bits_per_param / 32.0
        return dataclasses.replace(
            self,
            t_comm_edge=self.t_comm_edge * es,
            e_comm_edge=self.e_comm_edge * es,
            cloud_latency_mult=self.cloud_latency_mult * (cs / es),
        )


# Paper workloads: M = #params * 32 model bits; D = data bits per local
# iteration chosen by the paper so that Table I holds.
MNIST_MODEL_BITS = 21840 * 32
CIFAR_MODEL_BITS = 5852170 * 32
MNIST_DATA_BITS_PER_ITER = 1.2e6
CIFAR_DATA_BITS_PER_ITER = 2e8


def paper_workload(name: str, wireless: Optional[WirelessParams] = None) -> WorkloadCosts:
    w = wireless or WirelessParams()
    if name == "mnist":
        d, m = MNIST_DATA_BITS_PER_ITER, MNIST_MODEL_BITS
    elif name == "cifar10":
        d, m = CIFAR_DATA_BITS_PER_ITER, CIFAR_MODEL_BITS
    else:
        raise ValueError(name)
    return WorkloadCosts(
        t_comp=w.t_comp(d),
        t_comm_edge=w.t_comm(m),
        e_comp=w.e_comp(d),
        e_comm_edge=w.e_comm(m),
        cloud_latency_mult=w.cloud_latency_mult,
    )


def cloud_interval_time(costs: WorkloadCosts, kappa1: int, kappa2: int) -> float:
    return (
        kappa1 * kappa2 * costs.t_comp
        + kappa2 * costs.t_comm_edge
        + (costs.cloud_latency_mult - 1.0) * costs.t_comm_edge
    )


def cloud_interval_energy(costs: WorkloadCosts, kappa1: int, kappa2: int) -> float:
    return kappa1 * kappa2 * costs.e_comp + kappa2 * costs.e_comm_edge


def time_at_step(costs: WorkloadCosts, kappa1: int, kappa2: int, k: int) -> float:
    """Wall-clock time after k local updates (completed intervals + partials)."""
    full, rem = divmod(k, kappa1 * kappa2)
    t = full * cloud_interval_time(costs, kappa1, kappa2)
    t += rem * costs.t_comp
    t += (rem // kappa1) * costs.t_comm_edge
    return t


def energy_at_step(costs: WorkloadCosts, kappa1: int, kappa2: int, k: int) -> float:
    full, rem = divmod(k, kappa1 * kappa2)
    e = full * cloud_interval_energy(costs, kappa1, kappa2)
    e += rem * costs.e_comp
    e += (rem // kappa1) * costs.e_comm_edge
    return e
