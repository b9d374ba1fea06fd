"""Carry state built by the JAX package into the port.

The built graph (node table + both Markov CSRs) is the system's "weights":
``from_jax_state`` takes the JAX package's ``SparseMatrix.__getstate__()``
(pickled bytes, or the dict inside them) and returns the port's
SparseMatrix over the identical arrays, so both packages propagate the same
matrix.  ``ranges_from_jax`` takes the JAX package's co-occurrence count
ranges as numpy and returns the port's, so both factorize the same counts.
``checkpoint_from_jax`` reads a checkpoint directory that the JAX
package's ``checkpoint.embed_with_checkpointing`` wrote, so that the
port's :mod:`.checkpoint` resumes the run.  The state layouts are plain
arrays; nothing of the JAX package is imported.

The spectral siblings, sharded or not, carry nothing more: they have no
parameters, and both packages draw R, Ω and the sketches from the same
``np.random.default_rng(seed)`` calls over the same graph.
"""

from __future__ import annotations

import importlib
import io
import os
import pickle
from typing import Tuple, Union

import numpy as np
import torch

from .sparse import SparseMatrix

_KEYS = ("descriptor", "entity_ids", "entity_hashes", "column_ids",
         "row_sums", "indptr", "indices", "left_vals", "sym_vals")


def from_jax_state(state: Union[bytes, dict]) -> SparseMatrix:
    """Only pass bytes that the JAX package's ``__getstate__`` wrote:
    unpickling runs code from the bytes."""
    d = pickle.loads(state) if isinstance(state, (bytes, bytearray)) else state
    missing = [k for k in _KEYS if k not in d]
    if missing:
        raise ValueError(f"not a SparseMatrix state: missing {missing}")
    sm = SparseMatrix()
    sm.__setstate__(d)
    return sm


def ranges_from_jax(ranges, device="cpu") -> list:
    """The JAX package's count ranges ``(cen, ctx, cnt, m)`` (arrays padded
    to a bucket, the first ``m`` slots real; fetched as numpy) as the
    port's exactly sized int32 tensors on ``device``."""
    out = []
    for cen, ctx, cnt, m in ranges:
        m = int(m)
        out.append(tuple(
            torch.from_numpy(np.array(np.asarray(a)[:m],
                                      dtype=np.int32)).to(device)
            for a in (cen, ctx, cnt)) + (m,))
    return out


class _JaxGraph:
    """Stands in for the JAX package's SparseMatrix while unpickling: it
    keeps the state bytes that ``__reduce__`` hands to ``__setstate__``."""

    state = None

    def __setstate__(self, state):
        self.state = state


class _Restricted(pickle.Unpickler):
    """An unpickler that resolves only the globals in ``allowed``
    ((module, name) → object, or None to import the module's attribute)
    and refuses every other class."""

    def __init__(self, blob: bytes, allowed: dict):
        super().__init__(io.BytesIO(blob))
        self._allowed = allowed

    def find_class(self, module, name):
        if (module, name) not in self._allowed:
            raise pickle.UnpicklingError(
                f"refusing to unpickle {module}.{name}: not part of a "
                "cleora_tpu SparseMatrix checkpoint")
        found = self._allowed[(module, name)]
        if found is None:
            found = getattr(importlib.import_module(module), name)
        return found


# what numpy writes for the arrays inside the graph state (numpy 2 names
# its core module numpy._core, numpy 1 numpy.core)
_NUMPY_GLOBALS = {
    (core, name): None
    for core in ("numpy.core.multiarray", "numpy._core.multiarray")
    for name in ("_reconstruct", "scalar")
}
_NUMPY_GLOBALS.update({("numpy", "ndarray"): None, ("numpy", "dtype"): None})


def checkpoint_from_jax(
        directory: str) -> Tuple[SparseMatrix, np.ndarray, int]:
    """``(graph, embeddings, iteration)`` of a checkpoint directory that
    ``cleora_tpu.checkpoint`` wrote with its npz backend, the graph as the
    port's SparseMatrix.  The graph pickle is read by an unpickler that
    maps the JAX package's SparseMatrix to a stand-in and refuses every
    other class; the arrays inside it may only be numpy's."""
    with open(os.path.join(directory, "graph.pkl"), "rb") as f:
        outer = _Restricted(
            f.read(), {("cleora_tpu.sparse", "SparseMatrix"): _JaxGraph}
        ).load()
    if not isinstance(outer, _JaxGraph) or not isinstance(
            outer.state, (bytes, bytearray)):
        raise ValueError(f"{directory} holds no cleora_tpu SparseMatrix")
    graph = from_jax_state(
        _Restricted(bytes(outer.state), _NUMPY_GLOBALS).load())
    with np.load(os.path.join(directory, "state.npz")) as state:
        return graph, np.asarray(state["embeddings"]), int(state["iteration"])
