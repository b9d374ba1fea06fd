"""SparseMatrix — the hypergraph transition matrix, with a device CSR cache.

API parity with the reference PyO3 class ``pycleora.SparseMatrix``
(src/lib.rs:84-476): same constructors, propagate/embed methods, getters and
pickle state.  The numeric state is the host CSR built by
``cleora_tpu_torch.graph.builder`` (or its C++ core); a device copy
(:class:`~.ops.spmm.CsrMatrix`, original row order) is cached lazily per
(Markov type, device) and shared by all propagate/embed calls, as are the
entity hashes from which kernel K3 builds the init on the card.

Every compute method takes ``device=None``, which means CUDA; the CPU runs
only when asked for (``device="cpu"``).  ``num_workers`` is accepted for API
compatibility and ignored on the device.
"""

from __future__ import annotations

import pickle
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ._util import resolve_device, to_host
from .graph.builder import GraphData, build_graph
from .graph.columns import RelationDescriptor
from .graph.hashing import init_embeddings
from .ops.loop import effective_residual_weight, embed_loop, embed_loop_convergence
from .ops.init import device_init, hashes_as_int64
from .ops.memory import check_device_fit
from .ops.spmm import CsrMatrix, spmm


def _build_dispatch(lines, columns, hyperedge_trim_n, num_workers):
    """Prefer the C++ ingest core; fall back to the vectorized-numpy builder
    (CLEORA_TPU_NATIVE=0 forces the fallback)."""
    if not lines:
        raise ValueError("No valid hyperedge lines provided")
    try:
        from .graph.native import build_graph_native, native_available

        if native_available():
            return build_graph_native(lines, columns, hyperedge_trim_n,
                                      num_workers)
    except ValueError:
        raise
    except Exception as e:  # pragma: no cover - defensive fallback
        import warnings

        warnings.warn(f"native builder failed, using numpy fallback: {e}")
    return build_graph(lines, columns, hyperedge_trim_n, num_workers)


class SparseMatrix:
    """CSR-like Markov transition matrix over hashed entities."""

    def __init__(self, *args):
        # Parity: only the empty constructor is public (for unpickling);
        # use from_iterator / from_files (src/lib.rs:440-461).
        if args:
            raise ValueError(
                "SparseMatrix cannot be constructed directly. "
                "Use SparseMatrix.from_files() or SparseMatrix.from_iterator()."
            )
        self._data: Optional[GraphData] = None
        self._device_cache = {}

    # ------------------------------------------------------------------ build
    @classmethod
    def _from_graph_data(cls, data: GraphData) -> "SparseMatrix":
        sm = cls()
        sm._data = data
        return sm

    @staticmethod
    def from_iterator(
        hyperedges: Iterable[str],
        columns: str,
        hyperedge_trim_n: int = 16,
        num_workers: Optional[int] = None,
    ) -> "SparseMatrix":
        lines = []
        for line in hyperedges:
            if not isinstance(line, str):
                raise ValueError("Iterator elements must be strings")
            if "\n" in line:
                # one iterator element IS one line — an embedded newline
                # would silently mean different graphs on the native path
                # (splits into two lines) vs the numpy fallback / reference
                # (newline becomes part of an entity id)
                raise ValueError(
                    "Iterator elements must be single lines without '\\n' "
                    "(split multi-line strings before feeding, and strip "
                    "trailing newlines from file-read lines)"
                )
            lines.append(line)
        data = _build_dispatch(lines, columns, hyperedge_trim_n, num_workers)
        return SparseMatrix._from_graph_data(data)

    @staticmethod
    def from_edge_arrays(
        src,
        dst,
        columns: str = "complex::reflexive::node",
        hyperedge_trim_n: int = 16,
    ) -> "SparseMatrix":
        """Build directly from integer edge arrays, identical to feeding
        ``f"{s} {d}"`` lines without per-edge Python string objects.
        Dispatches to the C++ core via one vectorized text buffer when
        available; otherwise uses the pure-numpy pair builder."""
        s = np.asarray(src)
        d = np.asarray(dst)
        if s.shape != d.shape or s.ndim != 1:
            raise ValueError("src and dst must be 1-D arrays of equal length")
        if s.shape[0] == 0:
            raise ValueError("No valid hyperedge lines provided")
        try:
            from .graph.native import native_available

            if native_available():
                from .graph.columns import parse_fields

                cols = parse_fields(columns)
                if len(cols) == 1 and cols[0].reflexive:
                    # minimal decimal width keeps the U-array conversion cheap
                    w = max(
                        len(str(int(s.max()))), len(str(int(d.max()))),
                        len(str(int(s.min()))), len(str(int(d.min()))),
                    )
                    lines_arr = np.char.add(
                        np.char.add(s.astype(f"U{w}"), " "),
                        d.astype(f"U{w}"),
                    )
                    buf = "\n".join(lines_arr.tolist())
                    from .graph.native import build_graph_native

                    return SparseMatrix._from_graph_data(
                        build_graph_native([buf], columns, hyperedge_trim_n)
                    )
        except ValueError:
            raise
        except Exception:  # pragma: no cover - defensive fallback
            pass

        from .graph.builder import build_graph_pairs

        return SparseMatrix._from_graph_data(
            build_graph_pairs(src, dst, columns, hyperedge_trim_n)
        )

    @staticmethod
    def from_files(
        filepaths: Sequence[str],
        columns: str,
        hyperedge_trim_n: int = 16,
        num_workers: Optional[int] = None,
    ) -> "SparseMatrix":
        if not filepaths:
            raise ValueError("At least one file path is required")
        for fp in filepaths:
            if not (fp.endswith(".tsv") or fp.endswith(".csv") or fp.endswith(".txt")):
                raise ValueError(
                    f"Unsupported file format: {fp}. Supported: .tsv, .csv, .txt"
                )

        readable = []
        for fp in filepaths:
            try:
                open(fp, "rb").close()
                readable.append(fp)
            except OSError as e:  # parity: log-and-skip unreadable files
                import warnings

                warnings.warn(f"Cannot open file '{fp}': {e}")

        try:
            from .graph.native import build_graph_native_files, native_available

            if native_available() and readable:
                return SparseMatrix._from_graph_data(
                    build_graph_native_files(
                        readable, columns, hyperedge_trim_n, num_workers
                    )
                )
        except ValueError:
            raise
        except Exception as e:  # pragma: no cover - defensive fallback
            import warnings

            warnings.warn(f"native file builder failed, using fallback: {e}")

        def line_iter():
            for fp in readable:
                with open(fp, "rb", buffering=64 * 1024) as f:
                    for raw in f:
                        try:
                            # invalid UTF-8 lines are skipped (reference
                            # read_line error path, src/pipeline.rs:193-218)
                            line = raw.decode("utf-8")
                        except UnicodeDecodeError:
                            continue
                        line = line.rstrip("\n").rstrip("\r")
                        if line:
                            yield line

        data = _build_dispatch(
            list(line_iter()), columns, hyperedge_trim_n, num_workers
        )
        return SparseMatrix._from_graph_data(data)

    # ------------------------------------------------------------- inspection
    @property
    def data(self) -> GraphData:
        if self._data is None:
            raise RuntimeError("Empty SparseMatrix: build via from_iterator/from_files")
        return self._data

    @property
    def descriptor(self) -> RelationDescriptor:
        return self.data.descriptor

    @property
    def entity_ids(self) -> List[str]:
        return self.data.entity_ids

    @entity_ids.setter
    def entity_ids(self, value: List[str]):
        self.data.entity_ids = list(value)
        self._device_cache.pop("index_map", None)

    @property
    def _index_map(self):
        """Lazy entity→index dict (the reference scans the list per lookup)."""
        m = self._device_cache.get("index_map")
        if m is None:
            m = {eid: i for i, eid in enumerate(self.data.entity_ids)}
            self._device_cache["index_map"] = m
        return m

    @property
    def entity_degrees(self) -> np.ndarray:
        return self.data.row_sums.copy()

    @property
    def num_entities(self) -> int:
        return self.data.num_entities

    @property
    def num_edges(self) -> int:
        return self.data.num_edges

    def get_entity_index(self, entity_id: str) -> int:
        idx = self._index_map.get(entity_id)
        if idx is None:
            raise ValueError(f"Entity '{entity_id}' not found")
        return idx

    def get_entity_indices(self, entity_ids: Sequence[str]) -> List[int]:
        index_map = self._index_map
        out = []
        for eid in entity_ids:
            if eid not in index_map:
                raise ValueError(f"Entity '{eid}' not found")
            out.append(index_map[eid])
        return out

    def get_entity_column_mask(self, column_name: str) -> np.ndarray:
        d = self.descriptor
        column_id_by_name = {d.col_a_name: d.col_a_id, d.col_b_name: d.col_b_id}
        if column_name not in column_id_by_name:
            raise ValueError(
                f"Column name '{column_name}' not found. "
                f"Available: '{d.col_a_name}', '{d.col_b_name}'"
            )
        cid = column_id_by_name[column_name]
        return self.data.column_ids == np.uint8(cid)

    def get_neighbors(self, entity_id: str) -> List[Tuple[str, float]]:
        idx = self.get_entity_index(entity_id)
        data = self.data
        start, end = int(data.indptr[idx]), int(data.indptr[idx + 1])
        return [
            (data.entity_ids[int(data.indices[j])], float(data.left_vals[j]))
            for j in range(start, end)
        ]

    def to_sparse_csr(self, markov_type: Optional[str] = None):
        mt = markov_type if markov_type is not None else "left"
        if mt not in ("left", "symmetric"):
            raise ValueError(f"Unknown markov_type '{mt}'. Use 'left' or 'symmetric'.")
        data = self.data
        n = data.num_entities
        rows = np.repeat(
            np.arange(n, dtype=np.uint32), np.diff(data.indptr).astype(np.int64)
        )
        cols = data.indices.astype(np.uint32)
        vals = (data.sym_vals if mt == "symmetric" else data.left_vals).copy()
        return rows, cols, vals, n, n

    # ------------------------------------------------------------ device CSR
    def _device_csr(self, markov_type: str, device: torch.device) -> CsrMatrix:
        """The CSR of one Markov type on ``device``, built once and cached."""
        key = ("csr", markov_type, str(device))
        if key not in self._device_cache:
            data = self.data
            vals = data.sym_vals if markov_type == "symmetric" else data.left_vals
            self._device_cache[key] = CsrMatrix.from_numpy(
                data.indptr, data.indices, vals, device)
        return self._device_cache[key]

    def _device_hashes(self, device: torch.device) -> torch.Tensor:
        """The entity hashes on ``device`` (int64 view of the uint64 bits),
        uploaded once and cached."""
        key = ("hashes", str(device))
        if key not in self._device_cache:
            self._device_cache[key] = hashes_as_int64(
                self.data.entity_hashes).to(device)
        return self._device_cache[key]

    def _initial_state(self, feature_dim: int, seed: int,
                       device: torch.device) -> torch.Tensor:
        """The hash init as a float32 tensor on ``device``: built on the
        card by kernel K3 on CUDA (the single-device case of the JAX
        package's device init, cleora_tpu/parallel/state.py:91-126); the
        host's init on the CPU.  Bit for bit the same either way."""
        if device.type == "cuda":
            return device_init(self._device_hashes(device), feature_dim, seed)
        return torch.from_numpy(
            self.initialize_deterministically(feature_dim, seed))

    # ------------------------------------------------------------- compute API
    def _propagate(self, x, markov_type: str, device) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        if x.shape[0] != self.num_entities:
            raise ValueError(
                f"Embedding matrix has {x.shape[0]} rows but graph has "
                f"{self.num_entities} entities"
            )
        dev = resolve_device(device)
        csr = self._device_csr(markov_type, dev)
        return to_host(spmm(csr, torch.from_numpy(x).to(dev)))

    def left_markov_propagate(self, x, num_workers: Optional[int] = None,
                              device=None) -> np.ndarray:
        return self._propagate(x, "left", device)

    def symmetric_markov_propagate(self, x, num_workers: Optional[int] = None,
                                   device=None) -> np.ndarray:
        return self._propagate(x, "symmetric", device)

    def initialize_deterministically(self, feature_dim: int, seed: int = 0) -> np.ndarray:
        """Bit-exact parity with the reference hash init (src/lib.rs:242-252,478-488)."""
        return init_embeddings(self.data.entity_hashes, feature_dim, seed)

    def l2_normalize(self, x, num_workers: Optional[int] = None) -> np.ndarray:
        x = np.asarray(x, dtype=np.float32)
        norms = np.sqrt((x * x).sum(axis=1, keepdims=True))
        return x / np.maximum(norms, 1e-10)

    def _markov_name(self, propagation: str) -> str:
        if propagation not in ("left", "symmetric"):
            raise ValueError(
                f"Unknown propagation '{propagation}'. Use 'left' or 'symmetric'."
            )
        return propagation

    def _fast_loop_inputs(self, propagation, feature_dim, seed, device):
        mt = self._markov_name(propagation)
        dev = resolve_device(device)
        check_device_fit(self.num_entities, int(feature_dim),
                         self.num_edges, device=dev)
        return self._device_csr(mt, dev), self._initial_state(
            int(feature_dim), seed, dev)

    def embed_fast(
        self,
        feature_dim: int,
        num_iterations: int,
        propagation: str = "left",
        seed: int = 0,
        residual_weight: float = 0.0,
        num_workers: Optional[int] = None,
        device=None,
    ) -> np.ndarray:
        """The reference's Rust fast path: l2, no whitening."""
        csr, x0 = self._fast_loop_inputs(propagation, feature_dim, seed, device)
        # embed_fast mirrors the Rust fast path: w outside (0,1) is ignored
        w = effective_residual_weight(residual_weight, True)
        return to_host(embed_loop(csr, x0, int(num_iterations), w, "l2",
                                  False))

    def embed_fast_convergence(
        self,
        feature_dim: int,
        max_iterations: int,
        propagation: str = "left",
        seed: int = 0,
        residual_weight: float = 0.0,
        convergence_threshold: float = 0.0,
        num_workers: Optional[int] = None,
        device=None,
    ) -> Tuple[np.ndarray, int]:
        csr, x0 = self._fast_loop_inputs(propagation, feature_dim, seed, device)
        w = effective_residual_weight(residual_weight, True)
        out, iters = embed_loop_convergence(
            csr, x0, int(max_iterations), w, float(convergence_threshold),
            "l2", False,
        )
        return to_host(out), int(iters)

    # ---------------------------------------------------------------- dunders
    def __repr__(self) -> str:
        d = self.descriptor
        return (
            f"SparseMatrix(entities={self.num_entities}, edges={self.num_edges}, "
            f"columns=('{d.col_a_name}', '{d.col_b_name}'))"
        )

    def __len__(self) -> int:
        return self.num_entities

    def __getstate__(self):
        data = self.data
        return pickle.dumps(
            {
                "descriptor": (
                    data.descriptor.col_a_id,
                    data.descriptor.col_a_name,
                    data.descriptor.col_b_id,
                    data.descriptor.col_b_name,
                ),
                "entity_ids": data.entity_ids,
                "entity_hashes": data.entity_hashes,
                "column_ids": data.column_ids,
                "row_sums": data.row_sums,
                "indptr": data.indptr,
                "indices": data.indices,
                "left_vals": data.left_vals,
                "sym_vals": data.sym_vals,
            }
        )

    def __setstate__(self, state):
        d = pickle.loads(state) if isinstance(state, bytes) else state
        self._data = GraphData(
            descriptor=RelationDescriptor(*d["descriptor"]),
            entity_ids=d["entity_ids"],
            entity_hashes=d["entity_hashes"],
            column_ids=d["column_ids"],
            row_sums=d["row_sums"],
            indptr=d["indptr"],
            indices=d["indices"],
            left_vals=d["left_vals"],
            sym_vals=d["sym_vals"],
        )
        self._device_cache = {}

    def __reduce__(self):
        return (SparseMatrix, (), self.__getstate__())
