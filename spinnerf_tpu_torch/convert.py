"""Carry the JAX package's field parameters across to the port.

`fields_state_dicts` takes the JAX parameter tree as numpy arrays — what
`jax.tree.map(np.asarray, params)` gives for `init_params`' {"coarse",
"fine"} — and returns one state dict per field: `HashGridField` and
`NeRFField` from flax trees, `FusedMLPField` from the fused weight dict.
flax Dense kernels are [in, out]; `nn.Linear.weight` is [out, in].
"""
from __future__ import annotations

import numpy as np
import torch


def _is_fused(tree) -> bool:
    return "feat_w" in tree


def fused_weights(jax_dict) -> dict:
    """The JAX fused weight dict (`FusedMLPField.init`'s, numpy leaves) ->
    `FusedMLPField.weights` tensors (the same names, shapes and values)."""
    return {n: torch.from_numpy(np.array(v, np.float32))
            for n, v in jax_dict.items()}


def field_state_dict(tree) -> dict:
    """One field's parameters -> its state dict: a flax tree ({"params":
    {...}} or the inner dict) for `HashGridField`/`NeRFField`, or a fused
    weight dict for `FusedMLPField`."""
    if _is_fused(tree):
        return {f"weights.{n}": v for n, v in fused_weights(tree).items()}
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


def nerf_field_tree(model) -> dict:
    """A port `NeRFField`'s parameters as the flax tree of numpy arrays
    (the inverse of `field_state_dict` for its layers)."""
    return {"params": {
        name: {"kernel": lin.weight.detach().cpu().numpy().T.copy(),
               "bias": lin.bias.detach().cpu().numpy().copy()}
        for name, lin in model.named_children()}}
