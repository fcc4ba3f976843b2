"""Assigned architecture configs (public-literature specs): the
reference's ten modules, field for field.

Each module exposes CONFIG (full size) and SMOKE (reduced,
CPU-runnable).  `get_config(name)` / `get_smoke(name)` dispatch by id.
"""
from __future__ import annotations

import importlib

ARCH_IDS = [
    "internlm2_20b",
    "minicpm_2b",
    "granite_3_2b",
    "qwen2_72b",
    "llama4_scout_17b_a16e",
    "moonshot_v1_16b_a3b",
    "jamba_1_5_large_398b",
    "llama_3_2_vision_11b",
    "falcon_mamba_7b",
    "seamless_m4t_large_v2",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def _module(name: str):
    name = _ALIAS.get(name, name)
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def all_configs():
    return {i: get_config(i) for i in ARCH_IDS}
