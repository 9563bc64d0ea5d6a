"""Checkpoints (port of ``pddp_tpu/utils/checkpoint.py``), as numpy
``.npz`` files in place of orbax.

 * ``save_pytree`` / ``restore_pytree``: the tensors of any of the port's
   objects (a model, a cost, an ``ILQRResult``, a nest of tuples, lists
   and dicts) in a fixed order; everything else (sizes, flags, floats) is
   structure, which the restore takes from a template, as torch's
   ``load_state_dict`` does.
 * ``save_state_dict`` / ``load_state_dict``: a flat dict of arrays (a
   controller's warm-start state) in the same file as ``pddp_tpu``'s, so
   that either package loads what the other saved.
"""

from __future__ import annotations

import copy
import dataclasses
import enum
import types

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["save_pytree", "restore_pytree", "save_state_dict",
           "load_state_dict"]

_OPAQUE = (enum.Enum, type, types.FunctionType, types.MethodType,
           types.ModuleType, torch.Generator, torch.dtype, torch.device)


def _children(obj):
    """(rebuild, children) of a container or an object with fields, or
    None for a leaf or a structure value. Dict keys in sorted order."""
    if isinstance(obj, (tuple, list)):
        if hasattr(obj, "_fields"):    # a NamedTuple
            return (lambda c: type(obj)(*c)), list(obj)
        return (lambda c: type(obj)(c)), list(obj)
    if isinstance(obj, dict):
        keys = sorted(obj, key=str)
        return (lambda c: type(obj)(zip(keys, c))), [obj[k] for k in keys]
    if isinstance(obj, _OPAQUE) or not hasattr(obj, "__dict__"):
        return None
    if dataclasses.is_dataclass(obj):
        names = [f.name for f in dataclasses.fields(obj)]
    else:
        names = list(vars(obj))

    def rebuild(c):
        new = copy.copy(obj)
        for name, v in zip(names, c):
            object.__setattr__(new, name, v)
        return new
    return rebuild, [getattr(obj, n) for n in names]


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    node = _children(obj)
    if node is None:
        return []
    return [leaf for c in node[1] for leaf in _leaves(c)]


def _with_leaves(obj, it):
    if isinstance(obj, torch.Tensor):
        new = next(it)
        return torch.as_tensor(new, dtype=obj.dtype,
                               device=obj.device).requires_grad_(
                                   obj.requires_grad)
    node = _children(obj)
    if node is None:
        return obj
    rebuild, children = node
    return rebuild([_with_leaves(c, it) for c in children])


def _numpy(t):
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:   # numpy has no bfloat16; exact
            t = t.float()
        return t.numpy()
    return np.asarray(t)


def _npz(path):
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path, obj):
    """Writes the tensors of ``obj`` to ``path`` (``.npz`` appended where
    missing), in ``restore_pytree``'s order."""
    leaves = _leaves(obj)
    np.savez(_npz(path), **{"leaf_{:06d}".format(i): _numpy(t)
                            for i, t in enumerate(leaves)})


def restore_pytree(path, like):
    """A copy of ``like`` with its tensors read from a ``save_pytree``
    file, each in the dtype and on the device of ``like``'s tensor.

    Raises:
        ValueError: the file holds another number of tensors than
            ``like``.
    """
    n = len(_leaves(like))
    with np.load(_npz(path)) as data:
        stored = [data[k] for k in sorted(data.files)]
    if len(stored) != n:
        raise ValueError("Checkpoint has {} leaves; template has {}".format(
            len(stored), n))
    return _with_leaves(like, iter(stored))


def save_state_dict(path, state_dict):
    """Writes a flat dict of arrays or tensors (a controller's warm-start
    state) with ``np.savez``; None entries are left out."""
    np.savez(path, **{k: _numpy(v) for k, v in state_dict.items()
                      if v is not None})


def load_state_dict(path, *, device=None, dtype=None):
    """A dict of tensors from a ``save_state_dict`` file (either
    package's), on ``device`` (default ``cuda``), in ``dtype`` (default:
    each array's own)."""
    device = resolve_device(device)
    with np.load(path) as data:
        return {k: torch.as_tensor(data[k], dtype=dtype, device=device)
                for k in data.files}
