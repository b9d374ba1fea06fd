"""cleora_tpu_torch — the Cleora hypergraph embedder in PyTorch for one
NVIDIA H100.

The main path is ``embed(graph)``: the host builds the hypergraph into a
row-normalised Markov CSR and the hash init, then the card runs
``num_iterations`` × [SpMM propagate (kernel K1) → row normalise (kernel
K2) → PCA whiten (float32 matmul + eigh)].  K1 and K2 are hand-written CUDA
(``kernels/``), built from source at first use.

Every entry point runs on CUDA unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions.  Without a card and without
``device="cpu"`` a call raises.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ._util import resolve_device, to_host
from .ops.loop import (
    effective_residual_weight,
    embed_loop,
    embed_loop_convergence,
    embed_step,
)
from .ops.memory import check_device_fit
from .sparse import SparseMatrix

DEFAULT_FEATURE_DIM = 256
DEFAULT_NUM_ITERATIONS = 40

__version__ = "0.1.0"

__all__ = ["embed", "SparseMatrix", "DEFAULT_FEATURE_DIM",
           "DEFAULT_NUM_ITERATIONS"]


def _validate_propagation(propagation: str):
    if propagation not in ("left", "symmetric"):
        raise ValueError(
            f"Unknown propagation type: '{propagation}'. Use 'left' or 'symmetric'."
        )


def _compute_rmse(current: np.ndarray, previous: np.ndarray) -> float:
    diff = current.astype(np.float64, copy=False) - previous.astype(np.float64, copy=False)
    return float(np.sqrt(np.mean(diff * diff)))


def embed(
    graph: SparseMatrix,
    feature_dim: int = DEFAULT_FEATURE_DIM,
    num_iterations: Union[int, str] = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    seed: int = 0,
    initial_embeddings: Optional[np.ndarray] = None,
    num_workers: Optional[int] = None,
    callback: Optional[Callable[[int, np.ndarray], None]] = None,
    residual_weight: float = 0.0,
    convergence_threshold: float = 0.0,
    whiten: bool = True,
    dtype: str = "float32",
    canonical_shapes: Optional[bool] = None,
    device=None,
) -> np.ndarray:
    """Cleora embedding: num_iterations × [propagate → normalize → whiten].

    Semantics parity with the reference embed() (pycleora/__init__.py:51-127)
    and with ``cleora_tpu.embed``: normalization l2/l1/spectral/none, both
    residual behaviours, RMSE convergence checked from the second iteration,
    a per-iteration ``callback(i, embeddings)``, initial embeddings and
    whitening.

    ``dtype="bfloat16"`` stores the embedding state in bf16 while the SpMM,
    normalization and whitening compute in float32.  The returned array is
    always a writable float32 numpy array.

    ``canonical_shapes`` exists for the TPU's compile cache and is accepted
    and ignored.  ``num_workers`` is ignored on the device.  ``device=None``
    means CUDA; pass ``device="cpu"`` for the plain PyTorch path.
    """
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"Unknown dtype '{dtype}'. Use 'float32' or 'bfloat16'."
        )
    if isinstance(num_iterations, str):
        if num_iterations == "auto":
            num_iterations = DEFAULT_NUM_ITERATIONS
        else:
            raise ValueError(
                f"num_iterations must be an int or 'auto', got '{num_iterations}'"
            )
    if not hasattr(graph, "data"):
        raise NotImplementedError(
            "streamed-build (DiskGraph) input is not ported yet: it is the "
            "DiskGraph slice of the port (ROADMAP.md, queue A item 7)"
        )
    _validate_propagation(propagation)
    if normalization not in ("l2", "l1", "spectral", "none"):
        raise ValueError(
            f"Unknown normalization method: {normalization}. "
            "Use 'l2', 'l1', 'spectral', or 'none'."
        )

    # which reference path would this configuration have taken?  (Their
    # residual semantics differ — see effective_residual_weight.)
    residual_weight = effective_residual_weight(
        residual_weight,
        rust_fast_semantics=(initial_embeddings is None and callback is None
                             and normalization == "l2" and not whiten),
    )

    if initial_embeddings is not None:
        x0 = np.asarray(initial_embeddings, dtype=np.float32)
        if x0.shape[0] != graph.num_entities:
            raise ValueError(
                f"initial_embeddings has {x0.shape[0]} rows but graph has "
                f"{graph.num_entities} entities"
            )
        feature_dim = x0.shape[1]
    else:
        x0 = graph.initialize_deterministically(feature_dim, seed)

    dev = resolve_device(device)
    check_device_fit(graph.num_entities, int(feature_dim), graph.num_edges,
                     dtype, dev)
    csr = graph._device_csr(propagation, dev)
    x = torch.from_numpy(np.ascontiguousarray(x0)).to(dev)
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    w = float(residual_weight)

    if callback is None and convergence_threshold <= 0:
        return to_host(embed_loop(csr, x, int(num_iterations), w,
                                  normalization, bool(whiten)))

    if callback is None:
        out, _ = embed_loop_convergence(
            csr, x, int(num_iterations), w, float(convergence_threshold),
            normalization, bool(whiten),
        )
        return to_host(out)

    # callback path: the host sees every iteration; convergence is checked
    # on the host copies, as the reference's Python loop does
    host = to_host(x)
    for i in range(int(num_iterations)):
        x = embed_step(csr, x, w, normalization, bool(whiten))
        prev, host = host, to_host(x)
        callback(i, host.copy())
        if convergence_threshold > 0 and i > 0:
            if _compute_rmse(host, prev) < convergence_threshold:
                break
    return host
