"""Carry weights between the JAX package and the port as numpy arrays.

``BinaryLR``'s params are a ``(D,)`` float32 vector in both packages, so
the conversion is a checked copy: the shape must equal the model's
``param_shape``.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params, model, device="cuda") -> torch.Tensor:
    """A float32 tensor on ``device`` holding ``params`` (a numpy array, or
    anything ``np.asarray`` takes, such as a JAX array on the host)."""
    arr = np.asarray(params, dtype=np.float32)
    if arr.shape != tuple(model.param_shape):
        raise ValueError(
            f"params of shape {arr.shape} do not fit {type(model).__name__} "
            f"with param_shape {tuple(model.param_shape)}")
    return torch.from_numpy(arr.copy()).to(device)


def params_to_numpy(w: torch.Tensor) -> np.ndarray:
    """The weights as a host float32 numpy array (the JAX package takes it
    as-is)."""
    return w.detach().to("cpu", torch.float32).numpy().copy()
