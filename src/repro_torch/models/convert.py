"""Load the JAX reference's parameters into the port's modules.

:func:`params_from_reference` takes the reference's param tree as nested
dicts of numpy arrays (for example ``jax.tree.map(np.asarray, params)``)
and returns a state dict for :class:`~repro_torch.models.lm.CausalLM`:
the reference's keys joined with dots, the stacked ``groups`` axis
unstacked into per-layer weights (group g, layer i -> layer
``g * len(pattern) + i``; tail layer i follows the groups).  numpy only:
nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _flat(tree, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", np.asarray(val)


def reference_items(tree: dict, cfg: ArchConfig):
    """(port parameter name, numpy view) for every leaf of the reference
    tree, without copying."""
    gs = len(cfg.pattern)
    n_groups = cfg.n_layers // gs
    for top in ("embed", "final_norm", "lm_head"):
        if top in tree:            # lm_head: untied heads only
            yield from _flat(tree[top], f"{top}.")
    stack = tree["stack"]
    for i in range(gs if n_groups else 0):
        for name, arr in _flat(stack["groups"][f"l{i}"]):
            if arr.shape[0] != n_groups:
                raise ValueError(f"groups.l{i}.{name}: leading axis "
                                 f"{arr.shape[0]} != {n_groups} groups")
            for g in range(n_groups):
                yield f"stack.layers.{g * gs + i}.{name}", arr[g]
    for i in range(cfg.n_layers % gs):
        for name, arr in _flat(stack["tail"][f"l{i}"]):
            yield f"stack.layers.{n_groups * gs + i}.{name}", arr


def params_from_reference(tree: dict, cfg: ArchConfig
                          ) -> dict[str, torch.Tensor]:
    """A state dict for ``CausalLM(cfg)`` (``load_state_dict`` checks
    that every parameter is matched)."""
    return {name: torch.tensor(arr)
            for name, arr in reference_items(tree, cfg)}
