"""Explicit (name, mode) -> class registries (own copy of
rechorus_tpu/registry.py).

A model file calls @register_model; readers and runners register the
same way. `load_all` imports the modules the port has so far; a name it
does not have yet raises a KeyError that says so.
"""
from __future__ import annotations

import importlib
from typing import Dict

MODEL_REGISTRY: Dict[str, type] = {}
READER_REGISTRY: Dict[str, type] = {}
RUNNER_REGISTRY: Dict[str, type] = {}


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        cls.registered_name = name
        return cls

    return deco


def register_reader(name: str):
    def deco(cls):
        READER_REGISTRY[name] = cls
        return cls

    return deco


def register_runner(name: str):
    def deco(cls):
        RUNNER_REGISTRY[name] = cls
        return cls

    return deco


# Modules that contribute registrations; imported lazily so that importing
# the package stays light. Only what the port has is listed.
_MODULES = [
    "rechorus_tpu_torch.data.readers",
    "rechorus_tpu_torch.runners.base",
    "rechorus_tpu_torch.models.general.bprmf",
]


def load_all():
    for mod in _MODULES:
        importlib.import_module(mod)


def _lookup(registry: Dict[str, type], kind: str, key: str):
    load_all()
    if key not in registry:
        raise KeyError(f"Unknown {kind} '{key}': not ported yet or misspelled. "
                       f"Registered: {sorted(registry)}")
    return registry[key]


def get_model(name: str, mode: str = ""):
    """Resolve '<Name><Mode>'; '' mode = the base class registered as <Name>."""
    return _lookup(MODEL_REGISTRY, "model", name + mode)


def get_reader(name: str):
    return _lookup(READER_REGISTRY, "reader", name)


def get_runner(name: str):
    return _lookup(RUNNER_REGISTRY, "runner", name)
