"""Checkpoint abstraction (ray parity: python/ray/air/checkpoint.py:66 and
the file-based train/_checkpoint.py:30).

A Checkpoint is a directory (canonical form) or an in-memory dict that
morphs to/from a directory. A model's or optimizer's state checkpoints with
``save_pytree``/``load_pytree`` as a ``torch.save`` file of its full
``state_dict`` (the reference writes JAX pytrees with orbax or msgpack):
under DDP or FSDP2 the full tensors are gathered through
``torch.distributed.checkpoint.state_dict``, so a checkpoint written at one
world size or sharding loads at another.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Optional

_DICT_FILE = "checkpoint_dict.pkl"


class Checkpoint:
    def __init__(self, path: Optional[str] = None,
                 _data: Optional[Dict[str, Any]] = None):
        self._path = path
        self._data = _data

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(_data=dict(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path=path)

    # -- accessors ------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return dict(self._data)
        f = os.path.join(self._path, _DICT_FILE)
        if os.path.exists(f):
            with open(f, "rb") as fh:
                return pickle.load(fh)
        raise ValueError(f"checkpoint at {self._path} has no dict payload")

    def to_directory(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(tempfile.gettempdir(),
                                    f"rt_ckpt_{uuid.uuid4().hex[:8]}")
        os.makedirs(path, exist_ok=True)
        if self._path is not None and os.path.abspath(self._path) != os.path.abspath(path):
            for item in os.listdir(self._path):
                src = os.path.join(self._path, item)
                dst = os.path.join(path, item)
                if os.path.isdir(src):
                    shutil.copytree(src, dst, dirs_exist_ok=True)
                else:
                    shutil.copy2(src, dst)
        if self._data is not None:
            with open(os.path.join(path, _DICT_FILE), "wb") as fh:
                pickle.dump(self._data, fh, protocol=5)
        return path

    def as_directory(self):
        """Context manager yielding a directory view."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            if self._path is not None and self._data is None:
                yield self._path
            else:
                tmp = self.to_directory()
                try:
                    yield tmp
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)

        return _cm()

    @property
    def path(self) -> Optional[str]:
        return self._path

    def __repr__(self):
        return f"Checkpoint(path={self._path!r}, in_memory={self._data is not None})"


def _is_sharded(module) -> bool:
    """Whether FSDP2 holds ``module``'s parameters as DTensors."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in module.parameters())


def _writes() -> bool:
    """Rank 0 of a process group (or a process outside one) writes."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def save_pytree(tree, directory: str, name: str = "params", *, model=None):
    """Checkpoint ``tree`` into ``directory/<name>.pt``: a ``torch.nn.Module``
    (its full ``state_dict``), a ``torch.optim.Optimizer`` (its full state,
    keyed by parameter names; pass the ``model`` it optimizes) or a dict of
    tensors. Under DDP or FSDP2 every rank must call it (FSDP2 gathers the
    shards); rank 0 writes."""
    import torch
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict, get_optimizer_state_dict)

    opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
    if isinstance(tree, torch.nn.Module):
        state = get_model_state_dict(tree, options=opts)
    elif isinstance(tree, torch.optim.Optimizer):
        if model is None:
            raise ValueError("save_pytree(optimizer) needs model=: the state "
                             "is keyed by the model's parameter names")
        state = get_optimizer_state_dict(model, tree, options=opts)
    else:
        state = tree
    if _writes():
        os.makedirs(directory, exist_ok=True)
        target = os.path.join(directory, name + ".pt")
        torch.save(state, target + ".tmp")
        os.replace(target + ".tmp", target)


def load_pytree(directory: str, target, name: str = "params", *, model=None):
    """Load ``directory/<name>.pt`` into ``target`` in place and return it:
    a module (any wrapping: plain, DDP, FSDP2), an optimizer (with the
    ``model`` it optimizes), or None for the saved object itself. Every
    rank reads the file; FSDP2 keeps its own shard of each tensor."""
    import torch
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, set_model_state_dict, set_optimizer_state_dict)

    state = torch.load(os.path.join(directory, name + ".pt"),
                       map_location="cpu", weights_only=True)
    if target is None:
        return state
    if isinstance(target, torch.nn.Module):
        opts = StateDictOptions(full_state_dict=_is_sharded(target))
        set_model_state_dict(target, state, options=opts)
        return target
    if isinstance(target, torch.optim.Optimizer):
        if model is None:
            raise ValueError("load_pytree(optimizer) needs model=")
        opts = StateDictOptions(full_state_dict=_is_sharded(model))
        set_optimizer_state_dict(model, target, state, options=opts)
        return target
    raise TypeError(f"load_pytree cannot load into {type(target).__name__}")
