"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.configs import (
    arctic_480b,
    deepseek_7b,
    deepseek_v3_671b,
    granite_20b,
    granite_3_2b,
    internvl2_2b,
    musicgen_medium,
    recurrentgemma_9b,
    xlstm_350m,
    yi_9b,
)
from repro_torch.configs.base import ArchConfig

_MODULES = {
    "arctic-480b": arctic_480b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "internvl2-2b": internvl2_2b,
    "musicgen-medium": musicgen_medium,
    "xlstm-350m": xlstm_350m,
    "deepseek-7b": deepseek_7b,
    "yi-9b": yi_9b,
    "granite-20b": granite_20b,
    "granite-3-2b": granite_3_2b,
    "recurrentgemma-9b": recurrentgemma_9b,
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)


def get_config(name: str) -> ArchConfig:
    if name == "lm-100m":
        from repro_torch.configs.paper import LM_100M

        return LM_100M
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'; known: {ARCH_IDS + ('lm-100m',)}")
    return _MODULES[name].CONFIG


def get_smoke(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch '{name}'")
    return _MODULES[name].smoke()


def all_configs() -> Dict[str, ArchConfig]:
    return {k: m.CONFIG for k, m in _MODULES.items()}
