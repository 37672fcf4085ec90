"""Explicit (name, mode) -> class registries (own copy of
rechorus_tpu/registry.py).

A model file calls @register_model; readers and runners register the
same way. `load_all` imports every model module; an unknown name raises a
KeyError that names it.
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
# the package stays light. They bind the readers too, so the JAX package's
# `data/readers_all.py` shim has no counterpart here.
_MODULES = [
    "rechorus_tpu_torch.data.readers",
    "rechorus_tpu_torch.runners.base",
    "rechorus_tpu_torch.runners.buir",
    "rechorus_tpu_torch.runners.ctr",
    "rechorus_tpu_torch.runners.impression",
    "rechorus_tpu_torch.models.general.bprmf",
    "rechorus_tpu_torch.models.general.pop",
    "rechorus_tpu_torch.models.general.neumf",
    "rechorus_tpu_torch.models.general.directau",
    "rechorus_tpu_torch.models.general.lightgcn",
    "rechorus_tpu_torch.models.general.buir",
    "rechorus_tpu_torch.models.general.cfkg",
    "rechorus_tpu_torch.models.sequential.sasrec",
    "rechorus_tpu_torch.models.sequential.gru4rec",
    "rechorus_tpu_torch.models.sequential.narm",
    "rechorus_tpu_torch.models.sequential.caser",
    "rechorus_tpu_torch.models.sequential.fpmc",
    "rechorus_tpu_torch.models.sequential.kda",
    "rechorus_tpu_torch.models.sequential.tisasrec",
    "rechorus_tpu_torch.models.sequential.comirec",
    "rechorus_tpu_torch.models.sequential.slrcplus",
    "rechorus_tpu_torch.models.sequential.chorus",
    "rechorus_tpu_torch.models.sequential.contrarec",
    "rechorus_tpu_torch.models.sequential.timirec",
    "rechorus_tpu_torch.models.context.fm",
    "rechorus_tpu_torch.models.context.widedeep",
    "rechorus_tpu_torch.models.context.deepfm",
    "rechorus_tpu_torch.models.context.afm",
    "rechorus_tpu_torch.models.context.dcn",
    "rechorus_tpu_torch.models.context.dcnv2",
    "rechorus_tpu_torch.models.context.xdeepfm",
    "rechorus_tpu_torch.models.context.autoint",
    "rechorus_tpu_torch.models.context.sam",
    "rechorus_tpu_torch.models.context.finalmlp",
    "rechorus_tpu_torch.models.context_seq.din",
    "rechorus_tpu_torch.models.context_seq.dien",
    "rechorus_tpu_torch.models.context_seq.can",
    "rechorus_tpu_torch.models.context_seq.eta",
    "rechorus_tpu_torch.models.context_seq.sdim",
    "rechorus_tpu_torch.models.reranker.prm",
    "rechorus_tpu_torch.models.reranker.setrank",
    "rechorus_tpu_torch.models.reranker.mir",
    "rechorus_tpu_torch.models.developing.clrec",
    "rechorus_tpu_torch.models.developing.fourierta",
    "rechorus_tpu_torch.models.developing.srgnn",
    "rechorus_tpu_torch.models.developing.s3rec",
]


def load_all():
    for mod in _MODULES:
        importlib.import_module(mod)


def _lookup(registry: Dict[str, type], kind: str, key: str):
    load_all()
    if key not in registry:
        raise KeyError(f"Unknown {kind} '{key}': misspelled or not a registered name. "
                       f"Registered: {sorted(registry)}")
    return registry[key]


def get_model(name: str, mode: str = ""):
    """Resolve '<Name><Mode>'; '' mode = the base class registered as <Name>."""
    return _lookup(MODEL_REGISTRY, "model", name + mode)


def get_reader(name: str):
    return _lookup(READER_REGISTRY, "reader", name)


def get_runner(name: str):
    return _lookup(RUNNER_REGISTRY, "runner", name)
