"""Embedding-state lifecycle for the sharded loop: per-shard device init,
shard-granular output, and per-shard checkpoint/resume.

The port of cleora_tpu/parallel/state.py.  No process ever holds the full
(N, D) matrix unless the caller asks for it (``out="full"``):

* **init** — each shard builds its own rows on its device with kernel K3
  (``ops/init.py``) from its slice of the entity-hash table (lazy memmap
  reads for a DiskGraph); rows ≥ n_rows are exactly zero.
* **output** — each shard's rows go to the host in bounded row chunks,
  returned as this process's row block (:class:`EmbeddingShards`) or
  written straight into one standard ``.npy`` through a memmap.
* **checkpoint/resume** — per-process state files, two-phase (state files,
  barrier, then the meta written by rank 0), so a crash never corrupts the
  last good checkpoint.  The format differs from the JAX package's, whose
  checkpoints this module refuses: their meta does not match, so a run
  starts afresh instead of loading them.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .._util import to_host
from ..ops.init import device_init, hashes_as_int64

_META = "checkpoint.json"
_FORMAT = "cleora_tpu_torch.sharded_checkpoint.v1"


def _fetch_chunk_rows(row_bytes: int) -> int:
    """Rows per device→host transfer chunk: bounded transfers cap the
    host's peak at one chunk.  CLEORA_TPU_FETCH_MB overrides the 256 MB
    default (0 → unchunked)."""
    mb = float(os.environ.get("CLEORA_TPU_FETCH_MB", "256") or 0)
    if mb <= 0:
        return 1 << 62
    return max(1, int(mb * 1e6 / max(row_bytes, 1)))


def _iter_chunks(x: torch.Tensor,
                 rows: int) -> Iterator[Tuple[int, np.ndarray]]:
    """(offset, float32 host block) over the first ``rows`` rows of ``x``,
    one bounded device→host transfer each."""
    step = _fetch_chunk_rows(x.shape[1] * 4)
    for s in range(0, rows, step):
        yield s, to_host(x[s:min(s + step, rows)])


def entity_hashes(graph) -> np.ndarray:
    """The uint64 entity-hash table of a SparseMatrix / DiskGraph / piece
    (memmap for disk graphs — slicing reads lazily)."""
    if hasattr(graph, "data"):  # SparseMatrix
        return graph.data.entity_hashes
    return graph.entity_hashes


def shard_rows(mesh, n_rows: int, rows_per_shard: int) -> Tuple[int, int]:
    """Global rows [lo, hi) of this process's shard that are real."""
    lo = min(mesh.rank * rows_per_shard, n_rows)
    return lo, min(lo + rows_per_shard, n_rows)


def make_initial_state(mesh, n_rows: int, rows_per_shard: int,
                       hashes: np.ndarray, feature_dim: int, seed: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """This shard's (rows_per_shard, feature_dim) hash init on
    ``mesh.device``: kernel K3 on CUDA (the host init on the CPU) over the
    shard's hash slice, rows ≥ n_rows zero.  Bitwise equal to the shard's
    rows of ``pad_rows(init_embeddings(...))``."""
    lo, hi = shard_rows(mesh, n_rows, rows_per_shard)
    h = hashes_as_int64(np.array(hashes[lo:hi])).to(mesh.device)
    x = torch.zeros((rows_per_shard, int(feature_dim)), dtype=dtype,
                    device=mesh.device)
    if hi > lo:
        x[:hi - lo] = device_init(h, int(feature_dim), seed)
    return x


@dataclass
class EmbeddingShards:
    """This process's contiguous row block of a sharded embedding.

    ``rows`` covers global rows [lo, hi) of the (n_rows, feature_dim)
    matrix; ``bounds`` is the canonical shard row cut
    (graph.stream.shard_row_bounds) so blocks from all processes tile the
    full matrix exactly."""

    lo: int
    hi: int
    rows: np.ndarray
    n_rows: int
    feature_dim: int
    bounds: tuple

    @property
    def shape(self):
        return (self.n_rows, self.feature_dim)


def collect_shards(x: torch.Tensor, mesh, n_rows: int,
                   rows_per_shard: int) -> EmbeddingShards:
    """This process's real rows as a float32 host block, fetched in
    bounded chunks."""
    from ..graph.stream import shard_row_bounds

    lo, hi = shard_rows(mesh, n_rows, rows_per_shard)
    rows = np.empty((hi - lo, x.shape[1]), dtype=np.float32)
    for s, block in _iter_chunks(x, hi - lo):
        rows[s:s + block.shape[0]] = block
    return EmbeddingShards(
        lo=lo, hi=hi, rows=rows, n_rows=n_rows, feature_dim=x.shape[1],
        bounds=tuple(shard_row_bounds(n_rows, mesh.world_size)),
    )


def write_memmap(path: str, x: torch.Tensor, mesh, n_rows: int,
                 rows_per_shard: int) -> np.memmap:
    """Stream the sharded embedding into ONE standard ``.npy`` file.

    Rank 0 creates the file; every rank then writes its own rows in
    bounded chunks (a shared filesystem in multi-process runs), so the
    host peak is one chunk.  Returns a read-only memmap of the full
    (n_rows, D) matrix."""
    if mesh.rank == 0:
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                       shape=(n_rows, x.shape[1]))
        del mm
    mesh.barrier()
    lo, hi = shard_rows(mesh, n_rows, rows_per_shard)
    mm = np.lib.format.open_memmap(path, mode="r+")
    for s, block in _iter_chunks(x, hi - lo):
        mm[lo + s:lo + s + block.shape[0]] = block
    mm.flush()
    del mm
    mesh.barrier()
    return np.load(path, mmap_mode="r")


def fingerprint(params: dict) -> str:
    """Stable hash of the loop/layout parameters a checkpoint depends on."""
    blob = json.dumps(params, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def content_digest(sharded, mesh, x0: Optional[np.ndarray] = None) -> str:
    """Content fingerprint of this process's shard of the graph (every
    byte of its row pointer, columns and values) and of user-provided
    initial embeddings, so that a resume rejects a different input that
    shares the loop's parameters.  The per-process digests are
    all-gathered and combined, so every rank holds the same value."""
    h = hashlib.blake2b(digest_size=16)
    k = mesh.rank
    h.update(sharded.indptr(k).data)
    h.update(np.ascontiguousarray(sharded.cols[k]).data)
    h.update(np.ascontiguousarray(sharded.vals[k]).data)
    h.update(np.int64(sharded.n_rows).tobytes())
    if x0 is not None:
        x = np.ascontiguousarray(np.asarray(x0))
        h.update(x.data)
        h.update(str(x.shape).encode())
    mine = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8)
    every = mesh.all_gather(mine.to(mesh.device)).cpu().numpy()
    return hashlib.blake2b(every.tobytes(), digest_size=16).hexdigest()


class ShardedCheckpoint:
    """Two-phase per-process checkpoint of the sharded loop state.

    Layout: ``state_i{iter}_p{rank}.npy`` (this process's rows, stored
    dtype preserved — bf16 saved as a uint16 view) + ``checkpoint.json``
    written by rank 0 only after every rank has renamed its state file
    into place (barrier), so the meta always points at a complete
    iteration; stale files are removed only after the new meta lands.
    """

    def __init__(self, directory: str, fp: str, mesh):
        self.dir = directory
        self.fp = fp
        self.mesh = mesh
        os.makedirs(directory, exist_ok=True)

    def _meta_path(self):
        return os.path.join(self.dir, _META)

    def latest(self) -> Optional[dict]:
        """The last complete checkpoint's meta, or None (missing, another
        run configuration, or another package's format)."""
        try:
            with open(self._meta_path()) as f:
                meta = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        if meta.get("format") != _FORMAT or meta.get("fingerprint") != self.fp:
            return None
        return meta

    def _state_path(self, iteration: int, rank: int) -> str:
        return os.path.join(self.dir, f"state_i{iteration}_p{rank}.npy")

    def save(self, x: torch.Tensor, iteration: int,
             extra: Optional[dict] = None) -> None:
        """Persist this shard's state at ``iteration`` (every rank calls
        this collectively).  ``extra`` merges keys into the meta (e.g.
        ``converged``, so that a resume of a converged run returns at
        once)."""
        me = self.mesh.rank
        if x.dtype == torch.bfloat16:
            local = x.view(torch.int16).cpu().numpy().view(np.uint16)
        else:
            local = x.cpu().numpy()
        path = self._state_path(iteration, me)
        tmp = path + ".tmp.npy"
        np.save(tmp, local)
        os.replace(tmp, path)
        self.mesh.barrier()
        if me == 0:
            meta = {
                "format": _FORMAT,
                "fingerprint": self.fp,
                "iteration": int(iteration),
                "processes": int(self.mesh.world_size),
                "dtype": str(x.dtype).replace("torch.", ""),
                "state_shape": [int(s) for s in x.shape],
            }
            if extra:
                meta.update(extra)
            tmp = self._meta_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1)
            os.replace(tmp, self._meta_path())
        self.mesh.barrier()
        # the new meta is durable — drop this process's stale iterations
        for name in os.listdir(self.dir):
            if (name.startswith("state_i") and name.endswith(f"_p{me}.npy")
                    and name != os.path.basename(path)):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass

    def load(self, meta: dict) -> torch.Tensor:
        """This shard's state from the last checkpoint, on its device."""
        if meta["processes"] != self.mesh.world_size:
            raise ValueError(
                f"checkpoint was written by {meta['processes']} processes; "
                f"this run has {self.mesh.world_size} — process topology "
                "must match for resume"
            )
        local = np.load(self._state_path(meta["iteration"], self.mesh.rank))
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(local.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(local)
        return t.to(self.mesh.device)
