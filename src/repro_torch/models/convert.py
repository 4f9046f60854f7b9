"""Carry the JAX package's model weights into the port."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.layers import Params

__all__ = ["params_from_jax"]


def params_from_jax(tree: Params, device: torch.device | str = "cuda") -> Params:
    """The reference's parameter tree (nested dicts of arrays, blocks
    stacked on the layer axis as its ``_stack_init`` makes them; any array
    ``np.asarray`` takes) -> the port's tree on ``device`` (the card unless
    the caller asks for the CPU), leaf for leaf:
    same keys, shapes, dtypes and values.  Both use ``w: (d_in, d_out)``, so
    nothing is transposed."""
    return {
        key: params_from_jax(val, device) if isinstance(val, dict)
        else torch.from_numpy(np.array(val)).to(device)
        for key, val in tree.items()
    }
