"""Weights from the JAX package to the port.

``params_from_jax`` takes the param tree of ``repro.models.transformer.
LM.init``, already turned into numpy arrays by the caller (so this module
imports no JAX), and returns a ``state_dict`` for ``repro_torch``'s ``LM``:
keys are the tree paths joined by ``.``, bf16 leaves stay bf16 and the
fp32 norm scales stay fp32. Anything that does not map raises.
"""

from __future__ import annotations

import numpy as np
import torch


def _tensor(key: str, a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: same bits as torch.bfloat16
        return torch.from_numpy(np.array(a.view(np.uint16))).view(torch.bfloat16)
    if a.dtype == np.float32:
        return torch.from_numpy(np.array(a))
    raise TypeError(f"{key}: dtype {a.dtype} has no counterpart in the port's params")


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> flat ``{dotted.path: tensor}``."""
    state: dict[str, torch.Tensor] = {}

    def walk(node: dict, prefix: str) -> None:
        for name, leaf in node.items():
            if not isinstance(name, str) or not name or "." in name:
                raise KeyError(f"param name {name!r} under {prefix!r} does not map to a state_dict key")
            key = f"{prefix}.{name}" if prefix else name
            if isinstance(leaf, dict):
                walk(leaf, key)
            elif isinstance(leaf, np.ndarray):
                state[key] = _tensor(key, leaf)
            else:
                raise TypeError(f"{key}: leaf of type {type(leaf).__name__} is not a numpy array")

    walk(tree, "")
    return state
