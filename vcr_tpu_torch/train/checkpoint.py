"""Checkpoints with the reference's latest/best policy: the counterpart of
``vcr_tpu/train/checkpoint.py``.

A checkpoint is a directory holding ``tree.pt``, one ``torch.save`` of
``{"params": nested dicts of tensors, "opt_state": the torch optimizer's
state_dict()}``, and ``meta.json``, ``{epoch, n_iter, config,
val_meteor_score, best_val_meteor_score}`` plus ``batch_in_epoch`` for a
mid-epoch save. ``model_latest`` is written every epoch and ``model_best``
when the validation METEOR is at least the best so far. Resume restores the
optimizer state too, and adopts the checkpoint's config.

Writes are crash-atomic: the new checkpoint goes to a sibling ``.tmp``
directory, the old one is renamed to ``.old``, the new one into place, and
``.old`` removed; a reader takes ``.old`` where the directory itself is
incomplete (a kill between the two renames).

Loading uses ``torch.load(weights_only=True)`` onto the caller's device.
These are this package's checkpoints. The JAX package's (Orbax)
checkpoints are not read here: its ``--mode export_reference`` writes one as
a reference ``.net`` file, which ``convert.load_reference_checkpoint`` and
``--mode verify_parity`` read.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

from vcr_tpu_torch.train.optim import OptState


def _tree_path(path: str) -> str:
    return os.path.join(os.path.abspath(path), "tree.pt")


def _meta_path(path: str) -> str:
    return os.path.join(os.path.abspath(path), "meta.json")


def _detached(params):
    if isinstance(params, dict):
        return {k: _detached(v) for k, v in params.items()}
    return params.detach()


def save_checkpoint(path: str, params, opt_state, meta: Dict[str, Any]) -> None:
    """Write ``params`` (nested dicts of tensors), the optimizer's state (an
    OptState, or an optimizer state_dict) and ``meta`` to the directory
    ``path``, crash-atomically."""
    path = os.path.abspath(path)
    tmp, old = path + ".tmp", path + ".old"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    opt_sd = opt_state if isinstance(opt_state, dict) else opt_state.optimizer.state_dict()
    tree = {"params": _detached(params), "opt_state": opt_sd}
    torch.save(tree, _tree_path(tmp))
    with open(_meta_path(tmp), "w") as f:
        json.dump(meta, f, indent=2, default=str)
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def _complete(path: str) -> bool:
    """Loadable iff both the tree and the meta exist."""
    return os.path.exists(_tree_path(path)) and os.path.exists(_meta_path(path))


def _resolve(path: str) -> str:
    """The newest complete variant of a checkpoint directory: itself, else its
    ``.old``, else itself (so the caller's error names the primary path)."""
    path = os.path.abspath(path)
    if _complete(path):
        return path
    if _complete(path + ".old"):
        return path + ".old"
    return path


def load_checkpoint(path: str, device="cpu") -> Tuple[Any, Any, Dict[str, Any]]:
    """-> (params on ``device``, the optimizer's state_dict, meta)."""
    path = _resolve(path)
    if not _complete(path) and os.path.isdir(os.path.join(path, "tree")):
        raise NotImplementedError(
            f"{path} is a JAX package (Orbax) checkpoint, which this package does "
            "not read: export it with `python -m vcr_tpu.cli --mode "
            "export_reference`, then read the .net file with "
            "vcr_tpu_torch.convert.load_reference_checkpoint or `--mode "
            "verify_parity`")
    tree = torch.load(_tree_path(path), map_location=torch.device(device),
                      weights_only=True)
    with open(_meta_path(path)) as f:
        meta = json.load(f)
    return tree["params"], tree["opt_state"], meta


def peek_meta(path: str) -> Optional[Dict[str, Any]]:
    """Only the JSON sidecar (None without a complete checkpoint): resume
    adopts the embedded config before building the model."""
    path = _resolve(path)
    if not _complete(path):
        return None
    with open(_meta_path(path)) as f:
        return json.load(f)


def latest_path(save_path: str) -> str:
    return os.path.join(save_path, "model_latest")


def best_path(save_path: str) -> str:
    return os.path.join(save_path, "model_best")


def checkpoint_exists(path: str) -> bool:
    return _complete(_resolve(path))


def restore_into(params, saved) -> None:
    """Copy the saved tensors into ``params``' tensors in place (so an
    optimizer bound to them stays bound); the two trees must match."""
    if isinstance(params, dict):
        if not isinstance(saved, dict) or saved.keys() != params.keys():
            raise ValueError(f"the checkpoint's parameter tree does not match the "
                             f"model's, whose keys here are {sorted(params)}")
        for k in params:
            restore_into(params[k], saved[k])
        return
    if saved.shape != params.shape:
        raise ValueError(f"checkpoint shape {tuple(saved.shape)} does not match "
                         f"the model's {tuple(params.shape)}")
    with torch.no_grad():
        params.copy_(saved)


class CheckpointManager:
    """The latest/best policy."""

    def __init__(self, save_path: str):
        self.save_path = save_path
        os.makedirs(save_path, exist_ok=True)

    def save_epoch(self, params, opt_state, epoch: int, n_iter: int,
                   config_dict: Dict, val_meteor: float, best_meteor: float,
                   is_best: bool) -> None:
        meta = {
            "epoch": epoch,
            "n_iter": n_iter,
            "config": config_dict,
            "val_meteor_score": val_meteor,
            "best_val_meteor_score": best_meteor,
        }
        if is_best:
            save_checkpoint(best_path(self.save_path), params, opt_state, meta)
        save_checkpoint(latest_path(self.save_path), params, opt_state, meta)

    def try_resume(self, params, opt_state: OptState
                   ) -> Optional[Tuple[Any, OptState, Dict]]:
        """Load ``model_latest`` into ``params`` and ``opt_state`` in place
        -> (params, opt_state, meta); None without one. The tree is read onto
        the CPU; the copies into ``params`` and the optimizer's
        ``load_state_dict`` put each tensor on its parameter's device, the
        Adam step counts on the CPU, where a fresh optimizer keeps them."""
        p = latest_path(self.save_path)
        if not checkpoint_exists(p):
            return None
        saved, opt_saved, meta = load_checkpoint(p, "cpu")
        restore_into(params, saved)
        opt_state.optimizer.load_state_dict(opt_saved)
        return params, opt_state, meta
