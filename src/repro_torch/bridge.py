"""Carry parameters between the JAX package's trees and the port's.

For the LMs both sides keep one layout (``x @ W`` with ``W`` shaped
``[d_in, d_out]``, block weights stacked ``[L, ...]`` or, for a
heterogeneous stack, a tuple of per-layer trees; the same key names; no
``"head"`` leaf where the embeddings are tied), so ``params_from_jax`` /
``params_to_jax`` are a plain copy with no transposes that keeps the
tree's structure.  ResNet-18's convolution weights are HWIO in the
reference and OIHW in the port (``models/resnet.py``), so
``resnet_params_from_jax`` / ``resnet_params_to_jax`` transpose every
4-D leaf and copy the rest.  ``train_state_from_jax`` /
``train_state_to_jax`` carry a whole LM training state: the parameters,
the optimizer state, the step and, where the run keeps them, the top-k
hop's error-feedback buffer ``wire_ef`` and the gradient compressor's
``error_fb`` tree.  ``streaming_state_from_jax`` /
``streaming_state_to_jax`` carry the streaming runtime's state: the
``{"ue", "bs"}`` parameter halves and the BS's per-client f32 top-k
error-feedback residuals.  The JAX side is handed over as a tree of
numpy arrays (``jax.tree.map(np.asarray, params)``): the port imports
nothing of JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.trees import tree_map


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":                  # ml_dtypes' bfloat16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:                   # numpy has no bf16
        t = t.to(torch.float32)
    return t.numpy().copy()


def params_from_jax(tree, device="cpu"):
    """JAX parameter tree (dicts and tuples of numpy arrays) -> port
    params."""
    return tree_map(lambda a: _to_torch(a, device), tree)


def params_to_jax(params):
    """Port params -> dicts and tuples of numpy arrays (bf16 widened to
    f32), the inverse of ``params_from_jax`` for names and shapes."""
    return tree_map(_to_numpy, params)


def resnet_params_from_jax(tree, device="cpu"):
    """The reference's ResNet-18 tree -> the port's: HWIO convolution
    weights become OIHW."""
    return tree_map(
        lambda a: _to_torch(np.transpose(a, (3, 2, 0, 1)) if np.ndim(a) == 4
                            else a, device), tree)


def resnet_params_to_jax(params):
    """The port's ResNet-18 params -> the reference's numpy tree (OIHW ->
    HWIO), the inverse of ``resnet_params_from_jax``."""
    return tree_map(lambda t: np.ascontiguousarray(np.transpose(
        _to_numpy(t), (2, 3, 1, 0))) if t.dim() == 4 else _to_numpy(t),
        params)


_STATE_TREES = ("params", "opt_state", "wire_ef", "error_fb")


def train_state_from_jax(state, device="cpu") -> dict:
    """The reference's train state (numpy leaves) -> the port's: every
    tree of ``_STATE_TREES`` it holds, and the step as an int."""
    out = {k: params_from_jax(state[k], device)
           for k in _STATE_TREES if k in state}
    out["step"] = int(np.asarray(state["step"]))
    return out


def train_state_to_jax(state) -> dict:
    """The port's train state -> numpy trees and an int32 step, the
    inverse of ``train_state_from_jax``."""
    out = {k: params_to_jax(state[k]) for k in _STATE_TREES if k in state}
    out["step"] = np.asarray(state["step"], np.int32)
    return out


def streaming_state_from_jax(state, device="cpu") -> dict:
    """The reference streaming runtime's ``{"params": {"ue", "bs"},
    "ef": {client: residual}}`` (numpy leaves; ``ef`` optional) -> the
    port's."""
    out = {"params": params_from_jax(state["params"], device)}
    if "ef" in state:
        out["ef"] = {int(c): _to_torch(e, device)
                     for c, e in state["ef"].items() if e is not None}
    return out


def streaming_state_to_jax(state) -> dict:
    """The port's streaming state -> numpy trees, the inverse of
    ``streaming_state_from_jax``."""
    out = {"params": params_to_jax(state["params"])}
    if "ef" in state:
        out["ef"] = {int(c): _to_numpy(e) for c, e in state["ef"].items()}
    return out
