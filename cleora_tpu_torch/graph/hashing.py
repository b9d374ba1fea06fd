"""Entity hashing and deterministic embedding initialization.

Bit-exact re-implementations of the two hash functions the reference relies on
for reproducibility:

* XXH64 (seed 0) over entity-name bytes — reference: twox-hash 1.6.3 as used in
  the reference's ``src/entity.rs:109-114`` (``hash_entity``).
* FxHash-style single-step mix for deterministic embedding init — reference:
  rustc-hash 1.1.0 ``FxHasher::write_i64`` as used in
  the reference's ``src/lib.rs:478-488`` (``init_value``).

Both are implemented as vectorized numpy (host-side; hashing is an ingest-time
operation, not a device hot loop).  Strings are bucketed by byte-length so that
every bucket runs a fixed number of fully-vectorized rounds.
"""

from __future__ import annotations

import numpy as np

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)

_U64 = np.uint64
_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)

# FxHasher multiply constant (rustc-hash 1.1.0, 64-bit platform).
FX_K = np.uint64(0x517CC1B727220A95)
INIT_MAX_HASH = 8 * 1024 * 1024  # 2**23, reference src/lib.rs:485


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _xxh64_scalar(data: bytes, seed: int = 0) -> int:
    """Reference scalar XXH64 (used for tests and as slow-path oracle)."""
    with np.errstate(over="ignore"):
        seed = _U64(seed)
        n = len(data)
        buf = np.frombuffer(data, dtype=np.uint8)
        i = 0
        if n >= 32:
            v1 = seed + _P1 + _P2
            v2 = seed + _P2
            v3 = seed
            v4 = seed - _P1
            while i + 32 <= n:
                lanes = buf[i : i + 32].view("<u8")
                v1 = _rotl(v1 + lanes[0] * _P2, 31) * _P1
                v2 = _rotl(v2 + lanes[1] * _P2, 31) * _P1
                v3 = _rotl(v3 + lanes[2] * _P2, 31) * _P1
                v4 = _rotl(v4 + lanes[3] * _P2, 31) * _P1
                i += 32
            h = _rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)
            for v in (v1, v2, v3, v4):
                h ^= _rotl(v * _P2, 31) * _P1
                h = h * _P1 + _P4
        else:
            h = seed + _P5
        h = h + _U64(n)
        while i + 8 <= n:
            k1 = buf[i : i + 8].view("<u8")[0]
            k1 = _rotl(k1 * _P2, 31) * _P1
            h ^= k1
            h = _rotl(h, 27) * _P1 + _P4
            i += 8
        if i + 4 <= n:
            k1 = _U64(buf[i : i + 4].view("<u4")[0])
            h ^= k1 * _P1
            h = _rotl(h, 23) * _P2 + _P3
            i += 4
        while i < n:
            h ^= _U64(buf[i]) * _P5
            h = _rotl(h, 11) * _P1
            i += 1
        h ^= h >> _U64(33)
        h *= _P2
        h ^= h >> _U64(29)
        h *= _P3
        h ^= h >> _U64(32)
        return int(h)


def _xxh64_fixed_len(mat: np.ndarray, n: int, seed: int = 0) -> np.ndarray:
    """Vectorized XXH64 over a (B, n) uint8 matrix of same-length inputs."""
    with np.errstate(over="ignore"):
        seed = _U64(seed)
        B = mat.shape[0]
        i = 0
        if n >= 32:
            v = np.empty((4, B), dtype=np.uint64)
            v[0] = seed + _P1 + _P2
            v[1] = seed + _P2
            v[2] = seed
            v[3] = seed - _P1
            while i + 32 <= n:
                lanes = mat[:, i : i + 32].copy().view("<u8")  # (B, 4)
                for lane in range(4):
                    v[lane] = _rotl(v[lane] + lanes[:, lane] * _P2, 31) * _P1
                i += 32
            h = _rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)
            for lane in range(4):
                h ^= _rotl(v[lane] * _P2, 31) * _P1
                h = h * _P1 + _P4
        else:
            h = np.full(B, seed + _P5, dtype=np.uint64)
        h = h + _U64(n)
        while i + 8 <= n:
            k1 = mat[:, i : i + 8].copy().view("<u8")[:, 0]
            k1 = _rotl(k1 * _P2, 31) * _P1
            h ^= k1
            h = _rotl(h, 27) * _P1 + _P4
            i += 8
        if i + 4 <= n:
            k1 = mat[:, i : i + 4].copy().view("<u4")[:, 0].astype(np.uint64)
            h ^= k1 * _P1
            h = _rotl(h, 23) * _P2 + _P3
            i += 4
        while i < n:
            h ^= mat[:, i].astype(np.uint64) * _P5
            h = _rotl(h, 11) * _P1
            i += 1
        h ^= h >> _U64(33)
        h *= _P2
        h ^= h >> _U64(29)
        h *= _P3
        h ^= h >> _U64(32)
        return h


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of a single byte string."""
    return _xxh64_scalar(data, seed)


def hash_entity(entity: str) -> int:
    """Reference parity: ``hash_entity`` (src/entity.rs:109-114), seed 0."""
    return _xxh64_scalar(entity.encode("utf-8"), 0)


def hash_entities(entities, seed: int = 0) -> np.ndarray:
    """Vectorized XXH64 over a sequence of strings → uint64 array.

    Buckets strings by encoded byte-length; each bucket is hashed with a fully
    vectorized fixed-round schedule.
    """
    n = len(entities)
    out = np.zeros(n, dtype=np.uint64)
    if n == 0:
        return out
    encoded = [e.encode("utf-8") if isinstance(e, str) else bytes(e) for e in entities]
    lengths = np.fromiter((len(b) for b in encoded), dtype=np.int64, count=n)
    order = np.argsort(lengths, kind="stable")
    sorted_lengths = lengths[order]
    # group indices by length
    start = 0
    while start < n:
        L = sorted_lengths[start]
        end = int(np.searchsorted(sorted_lengths, L, side="right"))
        idx = order[start:end]
        if L == 0:
            out[idx] = _xxh64_scalar(b"", seed)
        else:
            mat = np.empty((len(idx), L), dtype=np.uint8)
            for r, j in enumerate(idx):
                mat[r] = np.frombuffer(encoded[j], dtype=np.uint8)
            out[idx] = _xxh64_fixed_len(mat, int(L), seed)
        start = end
    return out


def fx_hash_i64(x: np.ndarray) -> np.ndarray:
    """rustc-hash 1.1.0 FxHasher().write_i64(x).finish(), vectorized.

    Starting state is 0, so a single write reduces to ``(x as u64) * K``
    (rotate_left(5) of 0 is 0; xor with 0 state is identity).
    """
    with np.errstate(over="ignore"):
        return np.asarray(x, dtype=np.int64).view(np.uint64) * FX_K


_INIT_BLOCK_ROWS = 1 << 15


def init_embeddings(entity_hashes: np.ndarray, feature_dim: int, seed: int = 0) -> np.ndarray:
    """Deterministic hash init, bit-exact vs ``init_value`` (src/lib.rs:478-488).

    value[i, c] = (fx_hash(xxh64(id_i) as i64 + c + seed) as i64 % 2**23) / 2**23
    with Rust truncated (C-style) integer remainder.

    Rows are processed in blocks of ``_INIT_BLOCK_ROWS`` so the int64
    temporaries stay bounded (at 2M rows x 256 they would need ~12 GB);
    every element depends on its own row only, so the output is identical.
    """
    h = np.asarray(entity_hashes, dtype=np.uint64).view(np.int64)
    out = np.empty((h.shape[0], feature_dim), dtype=np.float32)
    cols = np.arange(feature_dim, dtype=np.int64) + np.int64(seed)
    for start in range(0, h.shape[0], _INIT_BLOCK_ROWS):
        hb = h[start:start + _INIT_BLOCK_ROWS]
        with np.errstate(over="ignore"):
            # (B, D) int64 sums with wrapping
            s = hb[:, None] + cols[None, :]
            mixed = fx_hash_i64(s.ravel()).view(np.int64)
        rem = np.fmod(mixed, np.int64(INIT_MAX_HASH))  # truncated remainder, like Rust %
        vals = rem.astype(np.float32) / np.float32(INIT_MAX_HASH)
        out[start:start + hb.shape[0]] = vals.reshape(hb.shape[0], feature_dim)
    return out
