"""Monocular depth providers for the stage-1 point lift (PyTorch port of
``more4d_tpu/models/depth.py``).

A provider is any callable image01 [H, W, 3] in [0, 1] -> depth [H, W]
float32 (a tensor or an array; ``stage1_generate`` takes either):

- ``unidepth_native`` — the port's UniDepth-V2 (``models/unidepth.py``),
  the counterpart of the JAX package's ``unidepth_jax``;
- ``precomputed`` — ``<name>.npy`` depth maps saved offline;
- ``constant`` — tests and debugging.

The JAX package's ``unidepth`` kind wraps the third-party ``unidepth``
package, which is not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Protocol

import numpy as np


class DepthProvider(Protocol):
    def __call__(self, image01):
        """image01: [H, W, 3] float in [0, 1] -> depth [H, W] float32."""
        ...


class ConstantDepthProvider:
    def __init__(self, depth: float = 2.0):
        self.depth = depth

    def __call__(self, image01):
        return np.full(tuple(image01.shape[:2]), self.depth, np.float32)


class PrecomputedDepthProvider:
    """Loads ``<name>.npy`` depth maps from a directory; the image's name is
    given by ``set_current(name)``."""

    def __init__(self, directory: str):
        self.directory = directory
        self._current: Optional[str] = None

    def set_current(self, name: str):
        self._current = name

    def __call__(self, image01):
        if self._current is None:
            raise ValueError("PrecomputedDepthProvider: call "
                             "set_current(name) first")
        path = os.path.join(self.directory, self._current + ".npy")
        return np.load(path).astype(np.float32)


def get_depth_provider(kind: str, **kw) -> DepthProvider:
    if kind == "constant":
        return ConstantDepthProvider(**kw)
    if kind == "precomputed":
        return PrecomputedDepthProvider(**kw)
    if kind == "unidepth_native":
        from .unidepth import UniDepthProvider

        return UniDepthProvider(**kw)
    if kind == "unidepth":
        raise NotImplementedError(
            "depth provider 'unidepth' wraps the third-party unidepth "
            "package and is not ported; use 'unidepth_native'")
    raise ValueError(f"unknown depth provider {kind}")
