"""Carry a graph built by the JAX package into the port.

The built graph (node table + both Markov CSRs) is the system's "weights":
``from_jax_state`` takes the JAX package's ``SparseMatrix.__getstate__()``
(pickled bytes, or the dict inside them) and returns the port's
SparseMatrix over the identical arrays, so both packages propagate the same
matrix.  The state layout is the shared pickle format; nothing of the JAX
package is imported.
"""

from __future__ import annotations

import pickle
from typing import Union

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
