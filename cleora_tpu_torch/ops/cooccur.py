"""Windowed co-occurrence counting and the PPMI transform on the device.

Counterpart of the JAX package's cleora_tpu/ops/cooccur.py (single-device
branches).  The walks stay on the device; per walk batch:

1. kernel K9 (``kernels/pair_enum.cu``) writes every windowed
   (center, context) pair in both directions as one int64 sort key
   ``((cen % passes)·n + cen)·n + ctx`` (INT64_MAX for a masked lane), so
   one ascending sort orders the batch by hash partition, center, context;
2. ``torch.sort`` sorts the keys (a library call, as ``lax.sort`` is an XLA
   primitive in the JAX program);
3. kernel K10 (``kernels/run_length.cu``) reduces the runs in one pass to
   (cen, ctx, cnt) triples and counts each partition's runs; every
   partition's segment is chain-merged into its accumulator by K10's merge
   form, a merge path over the two sorted ranges (the JAX program sorts
   their concatenation again; no sort is needed).

Partition ``s`` holds the centers with ``cen % passes == s``, so the ranges
are row-disjoint.  ``passes`` bounds one partition's merge working set, as
in the JAX package, but a single sweep over the corpus counts every
partition (the JAX package's ``_run_sweep``): the int64 key has no
``passes·n < 2³¹`` gate, so the per-pass path (``_run_pass``) and its walk
cache are not needed, and a resumed run sweeps once for the partitions its
checkpoint lacks.

The PPMI transform is kernel K11 (``kernels/ppmi.cu``): exact int64 column
sums and pair total over every range, then per range the row sums, the
positive-PMI values in float32 and the range's CSR row pointer, so each
range becomes one CSR in original row order (:func:`ppmi_csrs`).

Counts are integer-exact against the JAX package and the host sort-reduce
(``tests/test_torch_walks.py``).  On CUDA the wrappers launch the kernels;
on the CPU they run the plain versions beside them.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np
import torch

from .. import kernels
from .._util import resolve_device
from .spmm import CsrMatrix

_DEAD = torch.iinfo(torch.int64).max


# ------------------------------------------------------------- K9: pair keys
def pair_keys(walks: torch.Tensor, n_valid: int, n: int, window: int,
              passes: int) -> torch.Tensor:
    """int64 sort keys of every windowed pair of the first ``n_valid`` rows
    of int32 (B, L) ``walks``.  On CUDA this launches K9; on the CPU it
    runs :func:`pair_keys_plain`."""
    if walks.is_cuda:
        return kernels.pair_enum(walks, n_valid, n, window, passes)
    return pair_keys_plain(walks, n_valid, n, window, passes)


def pair_keys_plain(walks: torch.Tensor, n_valid: int, n: int, window: int,
                    passes: int) -> torch.Tensor:
    """Plain PyTorch version of K9: the enumeration of
    ``_reduce_walks_sweep_impl`` (cleora_tpu/ops/cooccur.py:220-234), in
    the same order, with the partition packed into an int64 key."""
    kernels.pair_keys_fit(n, passes)
    b, length = walks.shape
    w = walks.long()
    live = (torch.arange(b, device=walks.device) < n_valid)[:, None]
    parts = []
    for off in range(1, min(window, length - 1) + 1):
        a, c = w[:, :-off], w[:, off:]
        ok = (a >= 0) & (a < n) & (c >= 0) & (c < n) & live
        parts += [torch.where(ok, ((a % passes) * n + a) * n + c,
                              _DEAD).reshape(-1),
                  torch.where(ok, ((c % passes) * n + c) * n + a,
                              _DEAD).reshape(-1)]
    if not parts:
        return torch.empty((0,), dtype=torch.int64, device=walks.device)
    return torch.cat(parts)


# ---------------------------------------------------- K10: run-length reduce
def run_length(keys: torch.Tensor, n: int, passes: int):
    """``(cen, ctx, cnt, m_per)`` of the runs of ascending ``keys``, a run's
    count its length.  On CUDA this launches K10's sweep form; on the CPU it
    runs :func:`run_length_plain`."""
    if keys.is_cuda:
        return kernels.run_length(keys, n, passes)
    return run_length_plain(keys, None, n, passes)


def run_length_plain(keys: torch.Tensor, counts: Optional[torch.Tensor],
                     n: int, passes: int):
    """Plain PyTorch version of K10's sweep form: the run heads, a cumsum,
    an int64 ``index_add_`` of the counts wrapped to int32 (the JAX
    program's int32 ``segment_sum``), the decoded heads and a bincount of
    partitions."""
    live = keys != _DEAD
    head = live.clone()
    head[1:] &= keys[1:] != keys[:-1]
    ids = torch.cumsum(head, 0) - 1
    hk = keys[head]
    m = hk.shape[0]
    c = (torch.ones_like(keys) if counts is None else counts.long())
    sums = torch.zeros((m,), dtype=torch.int64, device=keys.device)
    sums.index_add_(0, ids[live], c[live])
    nn = n * n
    cen = ((hk % nn) // n).to(torch.int32)
    ctx = (hk % n).to(torch.int32)
    m_per = torch.bincount(hk // nn, minlength=passes)[:passes]
    return cen, ctx, sums.to(torch.int32), m_per.to(torch.int32)


# ------------------------------------------------------------ sweep + merges
def _reduce_sweep(walks: torch.Tensor, pad: int, n: int, window: int,
                  passes: int, keep: Optional[torch.Tensor] = None):
    """One batch's all-partition reduce (``_reduce_walks_sweep_impl``):
    K9, ``torch.sort``, K10.  ``keep`` (bool (passes,)) drops the keys of
    the other partitions before the sort.  Returns (cen, ctx, cnt, m_per
    as a host list)."""
    keys = pair_keys(walks, walks.shape[0] - pad, n, window, passes)
    if keep is not None:
        part = torch.clamp(keys // (n * n), max=passes)  # INT64_MAX: passes
        keys = keys[torch.cat([keep, keep.new_zeros(1)])[part]]
    keys = torch.sort(keys).values
    cen, ctx, cnt, m_per = run_length(keys, n, passes)
    return cen, ctx, cnt, [int(v) for v in m_per.cpu()]


def _merge(a, b, n: int):
    """Merge two ranges of one partition into one (``_merge_impl``, which
    sorts their concatenation): on CUDA K10's merge form, a merge path
    over the two sorted ranges; on the CPU :func:`merge_plain`."""
    if a[0].is_cuda:
        return kernels.run_length_merge(a, b)
    return merge_plain(a, b, n)


def merge_plain(a, b, n: int):
    """Plain PyTorch version of K10's merge form, the JAX program's order:
    the (cen, ctx) pairs packed as ``cen·n + ctx``, sorted with the counts
    as payload, reduced by :func:`run_length_plain`."""
    keys = torch.cat([a[0].long() * n + a[1], b[0].long() * n + b[1]])
    keys, order = torch.sort(keys)
    counts = torch.cat([a[2], b[2]])[order]
    del order
    cen, ctx, cnt, _ = run_length_plain(keys, counts, n, 1)
    return cen, ctx, cnt, int(cen.shape[0])


def _run_sweep(batches_fn, passes: int, n: int, window: int, skip=()):
    """Count every hash partition not in ``skip`` in one sweep over the
    corpus (``_run_sweep``, cleora_tpu/ops/cooccur.py:303-336): per batch,
    one reduce emits every partition's segment, which chain-merges into
    that partition's accumulator (the keys of skipped partitions are
    dropped before the sort).  Returns one range per partition (None for a
    skipped one), or None for an empty corpus."""
    acc: List = [None] * passes
    seen = False
    keep = None
    for walks, pad in batches_fn():
        seen = True
        if skip and keep is None:
            keep = torch.tensor([s not in skip for s in range(passes)],
                                device=walks.device)
        cen, ctx, cnt, m_per = _reduce_sweep(walks, pad, n, window, passes,
                                             keep)
        start = 0
        for s, m_s in enumerate(m_per):
            end = start + m_s
            if s not in skip:
                r_s = (cen[start:end], ctx[start:end], cnt[start:end], m_s)
                acc[s] = r_s if acc[s] is None else _merge(acc[s], r_s, n)
            start = end
        # the batch's buffer lives on only in the ranges that still view it
        r_s = None
        del cen, ctx, cnt
    return acc if seen else None


class CountCheckpoint:
    """Per-pass durable checkpoint of the counting stage
    (cleora_tpu/ops/cooccur.py:398-525, the same ``.npz`` format): one
    finished hash partition's (cen, ctx, cnt, m) per file, written by atomic
    rename and stamped with the run's ``fingerprint``, so a resume rejects
    ranges of another corpus and recounts.  ``every=k`` persists only the
    passes with ``s % k == 0``.  The finished embedding is marked done
    with :meth:`mark_done`."""

    _DONE = "embedding.json"

    def __init__(self, directory: str, fingerprint: str, every: int = 1):
        self.dir = directory
        self.fp = str(fingerprint)
        self.every = max(1, int(every))
        os.makedirs(directory, exist_ok=True)

    def _pass_path(self, s: int) -> str:
        return os.path.join(self.dir, f"counts_pass_{s:05d}.npz")

    def has_pass(self, s: int) -> bool:
        try:
            with np.load(self._pass_path(s)) as z:
                return str(z["fingerprint"]) == self.fp
        except Exception:  # missing, truncated (BadZipFile), foreign file —
            return False   # any unreadable pass simply recounts

    def load_pass(self, s: int, device):
        """(cen, ctx, cnt, m) on ``device``, or None when the pass is
        absent or from a different corpus."""
        try:
            with np.load(self._pass_path(s)) as z:
                if str(z["fingerprint"]) != self.fp:
                    return None
                m = int(z["m"])
                cen, ctx, cnt = (z[k][:m] for k in ("cen", "ctx", "cnt"))
        except Exception:  # see has_pass — unreadable means recount
            return None
        put = lambda a: torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.int32)).to(device)
        return put(cen), put(ctx), put(cnt), m

    def save_pass(self, s: int, r) -> None:
        """Persist one completed pass."""
        if r is None or s % self.every:
            return
        cen, ctx, cnt, m = r
        payload = {
            "fingerprint": np.asarray(self.fp),
            "m": np.int64(m),
            "cen": cen.cpu().numpy(),
            "ctx": ctx.cpu().numpy(),
            "cnt": cnt.cpu().numpy(),
        }
        path = self._pass_path(s)
        tmp = path + f".tmp{s}.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, path)

    def done_result(self, feature_dim: int, fact_params=None):
        """The finished embedding of a completed earlier run (read-only
        memmap), or None.  Validated against the fingerprint, the recorded
        output path, the expected shape and the factorization parameters,
        so a rerun with other factorization parameters refactorizes from
        the counted passes."""
        try:
            with open(os.path.join(self.dir, self._DONE)) as f:
                meta = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        if meta.get("fingerprint") != self.fp:
            return None
        if json.dumps(fact_params, sort_keys=True, default=str) != \
                json.dumps(meta.get("fact_params"), sort_keys=True,
                           default=str):
            return None
        try:
            mm = np.load(meta["path"], mmap_mode="r")
        except (FileNotFoundError, OSError, ValueError, KeyError):
            return None
        if mm.ndim != 2 or mm.shape[1] != feature_dim or \
                list(mm.shape) != meta.get("shape"):
            return None
        return mm

    def mark_done(self, path: str, shape, fact_params=None) -> None:
        meta = {
            "fingerprint": self.fp,
            "path": os.path.abspath(path),
            "shape": [int(x) for x in shape],
            "fact_params": fact_params,
        }
        tmp = os.path.join(self.dir, self._DONE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, os.path.join(self.dir, self._DONE))


def device_pair_counts(batches_fn, n: int, window: int, passes: int = 1,
                       checkpoint: Optional[CountCheckpoint] = None,
                       device=None, group=None):
    """Reduce device walk batches to device-resident unique
    (center, context, count) ranges.

    ``batches_fn()`` returns a fresh iterable of ``(walks, pad)``: int32
    (B, L) walks on the device (sentinel ``n`` for dead ends) and the
    number of trailing pad rows to ignore.  ``passes`` hash-partitions the
    counts by center id; one sweep counts every partition.  A
    ``checkpoint`` supplies the partitions it already holds (loaded onto
    ``device``); the sweep counts the rest and each is saved.

    Under a shard group (``group``, every rank holding the same batches)
    rank r counts the partitions ``s`` with ``s % P == r`` and drops the
    keys of the others before the sort (the JAX package's pass-parallel
    counting with ``gather_home=False``, cleora_tpu/ops/cooccur.py:677-753,
    without its fallback to one device for a corpus of one batch): the
    ranges stay on their rank.  The ranks sweep together or not at all
    (the walks may run collectives), and a checkpoint written under one
    rank count resumes under another.

    Returns ``(ranges, m_total)``: one ``(cen, ctx, cnt, m)`` per partition
    of this rank, in partition order, exactly ``m`` int32 entries each,
    sorted by (center, context); ``m_total`` counts every rank's; ``[]``
    for an empty corpus."""
    passes = max(1, int(passes))
    dev = (group.device if group is not None else
           resolve_device(device) if checkpoint is not None else None)
    world = group.world_size if group is not None else 1
    mine = [s for s in range(passes) if group is None or s % world ==
            group.rank]
    loaded = {s: None for s in mine}
    if checkpoint is not None:
        loaded = {s: checkpoint.load_pass(s, dev) if checkpoint.has_pass(s)
                  else None for s in mine}
    skip = set(range(passes)) - {s for s in mine if loaded[s] is None}
    sweep = len(skip) < passes
    if group is not None:
        sweep = int(group.all_reduce_(torch.tensor(
            [int(sweep)], device=dev))[0]) > 0
    if sweep:
        counted = _run_sweep(batches_fn, passes, n, window, skip)
        if counted is None:
            return [], 0
        for s in mine:
            if s not in skip:
                loaded[s] = counted[s]
                if checkpoint is not None:
                    checkpoint.save_pass(s, counted[s])
    ranges = [loaded[s] for s in mine if loaded[s] is not None]
    _check_count_overflow(ranges, n, group)
    m_total = sum(r[3] for r in ranges)
    if group is not None:
        m_total = int(group.all_reduce_(torch.tensor(
            [m_total], dtype=torch.int64, device=dev))[0])
    return ranges, m_total


def _check_count_overflow(ranges, n: int, group=None) -> None:
    """Counts are int32 (the host path counts in int64); a pair seen more
    than 2³¹ - 1 times wraps negative.  One reduction per range catches
    that first wrap (cleora_tpu/ops/cooccur.py:902-923); under a group the
    ranks raise together."""
    wrapped = any(m and int(cnt.min()) < 0 for _, _, cnt, m in ranges)
    if group is not None:
        wrapped = int(group.all_reduce_(torch.tensor(
            [int(wrapped)], device=group.device))[0]) > 0
    if wrapped:
        raise ValueError(
            "co-occurrence count overflow: one (center, context) pair "
            "exceeds 2^31 occurrences — use cooccurrence='host' "
            "(int64 counts) for this corpus"
        )


def pair_total(ranges, n: int) -> int:
    """Total counted pairs across ranges, summed exactly on the device."""
    return sum(int(cnt.sum(dtype=torch.int64)) for _, _, cnt, _ in ranges)


# ------------------------------------------------------------- K11: the PPMI
def ppmi_colsum_(ctx: torch.Tensor, cnt: torch.Tensor, col: torch.Tensor,
                 total: torch.Tensor) -> None:
    """``col[ctx] += cnt``, ``total += Σcnt`` (int64, in place).  On CUDA
    this launches K11's first pass; on the CPU it runs
    :func:`ppmi_colsum_plain`."""
    if ctx.is_cuda:
        kernels.ppmi_colsum_(ctx, cnt, col, total)
    else:
        ppmi_colsum_plain(ctx, cnt, col, total)


def ppmi_colsum_plain(ctx: torch.Tensor, cnt: torch.Tensor, col: torch.Tensor,
                      total: torch.Tensor) -> None:
    """Plain PyTorch version of K11's first pass."""
    col.index_add_(0, ctx.long(), cnt.long())
    total += cnt.sum(dtype=torch.int64)


def ppmi_values(cen: torch.Tensor, ctx: torch.Tensor, cnt: torch.Tensor,
                col: torch.Tensor, total: torch.Tensor, n: int):
    """``(vals, indptr)`` of one (cen, ctx)-sorted range.  On CUDA this
    launches K11; on the CPU it runs :func:`ppmi_values_plain`.  Raises
    ValueError where cen decreases or a cen or ctx leaves [0, n)."""
    if cen.is_cuda:
        return kernels.ppmi(cen, ctx, cnt, col, total, n)
    return ppmi_values_plain(cen, ctx, cnt, col, total, n)


def _check_ppmi_ids(ids: torch.Tensor, n: int, sorted_: bool) -> None:
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n
                        or sorted_ and bool(torch.any(ids[1:] < ids[:-1]))):
        raise ValueError("ppmi: cen must be non-decreasing node ids below "
                         "n, and ctx node ids below n")


def ppmi_rows_plain(cen: torch.Tensor, cnt: torch.Tensor, n: int):
    """Plain PyTorch version of K11's row pass: the range's CSR row pointer
    (int64 (n+1,)) and each row's exact int64 sum of ``cnt`` (n,).  Raises
    ValueError where cen decreases or leaves [0, n)."""
    c64 = cen.long()
    _check_ppmi_ids(c64, n, True)
    rs = torch.zeros((n,), dtype=torch.int64, device=cen.device)
    rs.index_add_(0, c64, cnt.long())
    indptr = torch.zeros((n + 1,), dtype=torch.int64, device=cen.device)
    torch.cumsum(torch.bincount(c64, minlength=n), 0, out=indptr[1:])
    return indptr, rs


def ppmi_vals_plain(cen: torch.Tensor, ctx: torch.Tensor, cnt: torch.Tensor,
                    col: torch.Tensor, total: torch.Tensor,
                    rs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11's values pass: one conversion of each
    int64 sum to float32, then ``_ppmi_range_impl``'s float32 arithmetic
    in its order (cleora_tpu/ops/cooccur.py:951-962).  Raises ValueError
    for a ctx outside [0, n)."""
    x64 = ctx.long()
    _check_ppmi_ids(x64, col.shape[0], False)
    rsf = torch.clamp_min(rs[cen.long()].to(torch.float32), 1e-10)
    cs = torch.clamp_min(col[x64].to(torch.float32), 1e-10)
    q = cnt.to(torch.float32) * total.to(torch.float32) / (rsf * cs)
    return torch.clamp_min(torch.log(torch.clamp_min(q, 1e-15)), 0.0)


def ppmi_values_plain(cen: torch.Tensor, ctx: torch.Tensor, cnt: torch.Tensor,
                      col: torch.Tensor, total: torch.Tensor, n: int):
    """Plain PyTorch version of K11: :func:`ppmi_rows_plain`, then
    :func:`ppmi_vals_plain`.  Returns ``(vals, indptr)``."""
    indptr, rs = ppmi_rows_plain(cen, cnt, n)
    return ppmi_vals_plain(cen, ctx, cnt, col, total, rs), indptr


def range_col_sums(ranges, n: int, device):
    """(col int64 (n,), total int64 (1,)) over every range: the
    cross-range phase of the transform (contexts span every range)."""
    col = torch.zeros((n,), dtype=torch.int64, device=device)
    total = torch.zeros((1,), dtype=torch.int64, device=device)
    for _, ctx, cnt, _ in ranges:
        ppmi_colsum_(ctx, cnt, col, total)
    return col, total


def ppmi_transform(ranges: list, n: int, col: torch.Tensor,
                   total: torch.Tensor):
    """Count ranges → one ``(rows, cols, vals, indptr)`` per range, yielded
    in order, given the reduced column sums and total.  Consumes ``ranges``
    (the caller's list empties), so each range's counts are freed once its
    values exist."""
    while ranges:
        cen, ctx, cnt, _ = ranges.pop(0)
        vals, indptr = ppmi_values(cen, ctx, cnt, col, total, n)
        del cnt
        yield cen, ctx, vals, indptr


def ppmi_ranges(ranges, n: int):
    """[(rows, cols, vals), ...] positive-PMI COO, one triple per range
    (cleora_tpu/ops/cooccur.py:1012-1020, without its padding: every
    triple is exactly the range's size)."""
    ranges = list(ranges)
    if not ranges:
        return ()
    col, total = range_col_sums(ranges, n, ranges[0][0].device)
    return tuple(p[:3] for p in ppmi_transform(ranges, n, col, total))


def ppmi_coo(cen, ctx, cnt, n: int):
    """Single-range convenience wrapper around :func:`ppmi_ranges`."""
    return ppmi_ranges([(cen, ctx, cnt, int(cen.shape[0]))], n)[0]


def ppmi_csrs(ranges: list, n: int) -> List[CsrMatrix]:
    """The PPMI matrix as one (n, n) CSR per range, in original row order
    (each row lives in exactly one range): the range's contexts are the
    column indices, its values the PPMI.  Consumes ``ranges``."""
    if not ranges:
        return []
    col, total = range_col_sums(ranges, n, ranges[0][0].device)
    return [CsrMatrix(indptr, cols, vals)
            for _, cols, vals, indptr in ppmi_transform(ranges, n, col, total)]
