"""Carry the JAX package's field parameters across to the port.

`fields_state_dicts` takes the JAX parameter tree as numpy arrays — what
`jax.tree.map(np.asarray, params)` gives for `init_params`' {"coarse",
"fine"} — and returns one `HashGridField` state dict per field. flax Dense
kernels are [in, out]; `nn.Linear.weight` is [out, in].
"""
from __future__ import annotations

import numpy as np
import torch


def field_state_dict(tree) -> dict:
    """One field's flax tree ({"params": {...}} or the inner dict) ->
    `HashGridField.state_dict()` layout."""
    tree = tree.get("params", tree)
    out = {}
    for name, leaf in tree.items():
        if name == "encoder":
            out["encoder.table"] = torch.from_numpy(
                np.array(leaf["table"], np.float32))
        else:
            out[f"{name}.weight"] = torch.from_numpy(
                np.array(leaf["kernel"], np.float32).T.copy())
            out[f"{name}.bias"] = torch.from_numpy(
                np.array(leaf["bias"], np.float32))
    return out


def fields_state_dicts(params) -> dict:
    """{"coarse": tree, "fine": tree} -> {"coarse": state dict, "fine": ...}."""
    return {k: field_state_dict(v) for k, v in params.items()}
