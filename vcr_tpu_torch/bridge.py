"""Move parameters between the JAX package's pytree and this package.

Both packages store weights in the same ``(in, out)`` layout under the same
key names, so a parameter tree maps leaf for leaf through numpy. A tree is
a nest of dicts, lists and tuples; ``None`` (a Darknet layer without
weights) stays ``None``, as it is a node without leaves to JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def from_jax_params(tree, device):
    """A nest of dicts, lists and tuples of arrays (numpy, or anything
    ``np.asarray`` reads) -> the same nest of torch tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_params(v, device) for v in tree)
    if tree is None:
        return None
    arr = np.asarray(tree)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"cannot bridge a parameter of dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_numpy(params):
    """The port's parameter nest -> the same nest of numpy arrays."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(to_numpy(v) for v in params)
    if params is None:
        return None
    return params.detach().cpu().numpy()


def from_jax_darknet(net, device):
    """A JAX package ``Darknet`` -> this package's, with the same cfg
    blocks, weights and header (and so the same ``net_info``)."""
    from vcr_tpu_torch.models.darknet import Darknet

    return Darknet.from_blocks([dict(b) for b in net.blocks],
                               from_jax_params(list(net.params), device),
                               np.asarray(net.header, dtype=np.int32).copy())
