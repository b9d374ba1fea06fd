"""Checkpoint / resume of ``embed`` (the port of cleora_tpu/checkpoint.py).

The reference's persistence surface is (a) whole-graph pickling via bincode
(reference src/lib.rs:463-476), (b) embeddings npz/csv/tsv/parquet
(reference io_utils.py:78-144), and (c) a documented manual dimension-sharding
resume workflow.  Here checkpoints are directories holding the pickled graph,
the embedding matrix, and the iteration counter, written atomically — an
interrupted 40-iteration embed resumes from the last saved step.

The state is an ``npz`` file, as the JAX package writes with its default
backend.  Its ``backend="orbax"`` stores the state through a JAX library
and is not available here: the port raises ValueError for it.  A directory
that the JAX package wrote (npz backend) is read by
:func:`~.convert.checkpoint_from_jax`, which returns the port's graph.

Deterministic hash init means restart-from-scratch is always available; this
module makes restart-from-iteration-k cheap too.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Optional, Tuple

import numpy as np

_GRAPH_FILE = "graph.pkl"
_STATE_FILE = "state.npz"


def _check_backend(backend: str) -> None:
    if backend != "npz":
        raise ValueError(
            f"Unknown backend '{backend}'. Use 'npz' (the orbax backend is "
            "a JAX library, which the port does not use)."
        )


def save_checkpoint(
    directory: str,
    graph,
    embeddings: np.ndarray,
    iteration: int,
    save_graph: bool = True,
    backend: str = "npz",
) -> None:
    """Atomically write (graph, embeddings, iteration) into ``directory``.

    ``save_graph=False`` skips re-pickling the (immutable) graph on
    subsequent saves — only the state is rewritten.  ``backend`` must be
    "npz".
    """
    _check_backend(backend)
    os.makedirs(directory, exist_ok=True)
    if save_graph or not os.path.exists(os.path.join(directory, _GRAPH_FILE)):
        _atomic_write(
            os.path.join(directory, _GRAPH_FILE), pickle.dumps(graph)
        )
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, embeddings=embeddings,
                 iteration=np.int64(iteration))
        os.replace(tmp, os.path.join(directory, _STATE_FILE))
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def load_checkpoint(directory: str) -> Tuple[object, np.ndarray, int]:
    """Load (graph, embeddings, iteration) from a checkpoint directory.
    Unpickles the graph: only load directories this package wrote."""
    with open(os.path.join(directory, _GRAPH_FILE), "rb") as f:
        graph = pickle.load(f)
    with np.load(os.path.join(directory, _STATE_FILE)) as state:
        return graph, np.asarray(state["embeddings"]), int(state["iteration"])


def has_checkpoint(directory: str) -> bool:
    return (os.path.exists(os.path.join(directory, _GRAPH_FILE))
            and os.path.exists(os.path.join(directory, _STATE_FILE)))


def embed_with_checkpointing(
    graph,
    feature_dim: int = 256,
    num_iterations: int = 40,
    checkpoint_dir: str = "cleora_ckpt",
    checkpoint_every: int = 5,
    resume: bool = True,
    backend: str = "npz",
    **embed_kwargs,
) -> np.ndarray:
    """embed() that checkpoints every ``checkpoint_every`` iterations and
    resumes from the last checkpoint when ``resume`` and one exists.

    Runs ``checkpoint_every`` iterations per call of ``embed`` — the
    checkpoint cadence is the only host copy.  ``backend`` must be "npz",
    as in :func:`save_checkpoint`; ``embed_kwargs`` (``device=`` among
    them) go to :func:`embed`.
    """
    from . import embed

    _check_backend(backend)

    start_iter = 0
    x: Optional[np.ndarray] = None
    if resume and has_checkpoint(checkpoint_dir):
        _, x, start_iter = load_checkpoint(checkpoint_dir)
        if x.shape[1] != feature_dim:
            raise ValueError(
                f"Checkpoint feature_dim {x.shape[1]} != requested {feature_dim}"
            )

    if x is None and start_iter >= num_iterations:
        # num_iterations == 0 with no checkpoint: still return the
        # (deterministic-init) embeddings, like embed() itself would
        return embed(graph, feature_dim=feature_dim, num_iterations=0,
                     **embed_kwargs)

    it = start_iter
    while it < num_iterations:
        chunk = min(checkpoint_every, num_iterations - it)
        x = embed(
            graph,
            feature_dim=feature_dim,
            num_iterations=chunk,
            initial_embeddings=x,
            **embed_kwargs,
        )
        it += chunk
        save_checkpoint(checkpoint_dir, graph, x, it,
                        save_graph=(it == chunk), backend=backend)
    return x


def _atomic_write(path: str, blob: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
