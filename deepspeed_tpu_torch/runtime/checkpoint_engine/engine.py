"""Checkpoint backends (counterpart of
``deepspeed_tpu/runtime/checkpoint_engine/engine.py``): the pluggable
``CheckpointEngine`` surface (create / save / load / commit) and the
JAX package's flat-npz layout, ``NpzCheckpointEngine``: one
``<tag>/state.npz`` whose keys are the state's tree paths as the JAX code
joins them (``"/".join(str(getattr(k, "key", k)) ...)``: a dict key as
it is, a NamedTuple field as ``.name``, a tuple entry as ``[i]``), so a
checkpoint crosses between the two packages.

Leaves are host numpy arrays.  numpy has no bf16: a bf16 leaf is stored
as its 2-byte words in a ``V2`` array, as ``np.savez`` stores the JAX
package's ``ml_dtypes.bfloat16`` leaves, and read back by taking the
dtype from the loading engine's own template (:func:`from_host`).

``AsyncNpzCheckpointEngine`` (``checkpoint.async_save``) writes on a
background thread; the caller hands it a host snapshot it owns (the
training engine updates its params in place, so the snapshot is taken
before ``save`` returns) and ``commit`` joins the writer.
"""
import os
import threading
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

#: a bf16 leaf's numpy form: its 2-byte words
BF16_NP = np.dtype("V2")


# ---------------------------------------------------------------- tree paths
def flatten_state(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the JAX package's key form: dict entries by
    key, NamedTuple fields as ``.name``, tuple entries as ``[i]``;
    ``None`` and empty containers hold no leaf."""
    def join(k):
        return k if not prefix else f"{prefix}/{k}"
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in flatten_state(v,
                                                                  join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for k, v in zip(tree._fields, tree)
                for p in flatten_state(v, join(f".{k}"))]
    if isinstance(tree, tuple):
        return [p for i, v in enumerate(tree)
                for p in flatten_state(v, join(f"[{i}]"))]
    return [(prefix, tree)]


def unflatten_like(template, values: Dict[str, Any], prefix: str = ""):
    """``template`` with each leaf replaced by ``values[key]`` (the keys of
    :func:`flatten_state`)."""
    def join(k):
        return k if not prefix else f"{prefix}/{k}"
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: unflatten_like(v, values, join(k))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(unflatten_like(v, values, join(f".{k}"))
                                for k, v in zip(template._fields, template)))
    if isinstance(template, tuple):
        return tuple(unflatten_like(v, values, join(f"[{i}]"))
                     for i, v in enumerate(template))
    return values[prefix]


# ------------------------------------------------------------- host arrays
def to_host(leaf) -> np.ndarray:
    """A host copy the caller owns: tensors through a device-to-host copy
    (bf16 as ``V2`` words), Python ints (the counts) as 0-d int32."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).to("cpu", copy=True).numpy() \
                .view(BF16_NP)
        return t.to("cpu", copy=True).numpy()
    return np.asarray(int(leaf), np.int32)


def from_host(arr: np.ndarray, like):
    """``arr`` as ``like`` holds it: a tensor of ``like``'s dtype and
    device (a ``V2`` leaf's words reinterpreted as bf16; a JAX-written
    bf16 leaf loads as ``V2`` too), or a Python int (a count)."""
    arr = np.asarray(arr)
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf shape {tuple(arr.shape)} != "
                             f"{tuple(like.shape)}")
        if arr.dtype.kind == "V":
            if arr.itemsize != 2 or like.dtype != torch.bfloat16:
                raise ValueError(f"checkpoint leaf of {arr.dtype} for a "
                                 f"{like.dtype} leaf")
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
                .view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        # ascontiguousarray makes a 0-d leaf (the scaler's) 1-d
        return t.reshape(like.shape).to(like.device, like.dtype)
    return int(arr)


# ------------------------------------------------------------ the backends
class CheckpointEngine:
    """Pluggable save / load backend (the reference's create / save / load
    / commit surface).  ``save`` takes a flat ``{key: host array}``."""

    #: async engines set True: the training engine then defers commit and
    #: the tag's publication until ``wait_pending_checkpoint``
    is_async = False

    def __init__(self, config_params=None):
        self.config_params = config_params

    def create(self, tag: str):
        """Start a checkpoint under ``tag``."""

    def save(self, state_dict: Dict[str, np.ndarray], path: str):
        raise NotImplementedError

    def load(self, path: str, template=None) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        """Finalize ``tag`` (async engines finish their write here)."""
        return True


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


class NpzCheckpointEngine(CheckpointEngine):
    """The JAX package's flat-npz backend: one ``<path>.npz``, written to a
    temporary name, fsynced and renamed (a crash never leaves a torn file
    at the published name)."""

    def save(self, state_dict, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        final = _npz_path(path)
        tmp = final + ".tmp.npz"
        try:
            np.savez(tmp, **state_dict)
            with open(tmp, "rb+") as f:
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def load(self, path: str, template=None):
        """``{key: array}`` (every stored key, or ``template``'s keys; a
        key missing from the file raises KeyError naming it)."""
        with np.load(_npz_path(path)) as data:
            keys = data.files if template is None else list(template)
            missing = [k for k in keys if k not in data.files]
            if missing:
                raise KeyError(f"checkpoint {path}: no leaf {missing[:5]} "
                               f"({len(missing)} missing)")
            return {k: data[k] for k in keys}


class AsyncNpzCheckpointEngine(NpzCheckpointEngine):
    """``checkpoint.async_save``: ``save`` hands the (caller-owned) host
    snapshot to a writer thread and returns; ``commit`` joins it and
    raises what it raised.  One write in flight at a time."""

    is_async = True

    def __init__(self, config_params=None):
        super().__init__(config_params)
        self._thread = None
        self._error = None

    def save(self, state_dict, path: str):
        self.commit(None)

        def write():
            try:
                NpzCheckpointEngine.save(self, state_dict, path)
            except BaseException as e:       # raised again by commit
                self._error = e
        self._thread = threading.Thread(target=write, name="ds-ckpt-write",
                                        daemon=False)
        self._thread.start()

    def load(self, path: str, template=None):
        self.commit(None)
        return super().load(path, template)

    def commit(self, tag) -> bool:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        return True
