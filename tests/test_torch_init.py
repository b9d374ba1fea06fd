"""The port's hash init (kernel K3's plain version) against the JAX
package's device init and the host init: bitwise.

The hashes are 20,000 random uint64 values with 0, 2**64-1 and values with
the top bit set among them; widths and seeds are those chip_smoke.py holds
K3 to on the card.  K3 itself: tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cleora_tpu.graph.hashing import init_embeddings as jax_host_init
from cleora_tpu.ops.init import col_offsets, device_init_rows, split_hashes
from cleora_tpu_torch import kernels
from cleora_tpu_torch.convert import from_jax_state
from cleora_tpu_torch.graph.hashing import init_embeddings
from cleora_tpu_torch.ops.init import (
    device_init,
    device_init_plain,
    hashes_as_int64,
)
from torch_test_support import one_torch_thread  # noqa: F401

WIDTHS = (1, 7, 256, 300)
SEEDS = (0, 7, -3, 2**40 + 5)


@pytest.fixture(scope="module")
def hashes():
    h = np.random.default_rng(23).integers(
        0, 2**64 - 1, size=20_000, dtype=np.uint64, endpoint=True)
    h[:5] = [0, 2**64 - 1, 2**63, 2**63 - 1, 2**63 + 1]
    assert (h >> np.uint64(63)).sum() > 9000  # about half have the top bit
    return h


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_init_bitwise_vs_jax_device_init(hashes, d, seed):
    ours = device_init_plain(hashes_as_int64(hashes), d, seed).numpy()
    ref = np.asarray(device_init_rows(
        *(jnp.asarray(a) for a in split_hashes(hashes)),
        *(jnp.asarray(a) for a in col_offsets(d, seed))))
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == ref.shape == (hashes.shape[0], d)
    assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_init_bitwise_vs_host_init(hashes, d, seed):
    ours = device_init_plain(hashes_as_int64(hashes), d, seed).numpy()
    assert ours.tobytes() == init_embeddings(hashes, d, seed).tobytes()
    assert ours.tobytes() == jax_host_init(hashes, d, seed).tobytes()


def test_hashes_travel_as_an_int64_view(hashes):
    t = hashes_as_int64(hashes)
    assert t.dtype == torch.int64
    assert t.numpy().view(np.uint64).tobytes() == hashes.tobytes()
    assert int(t[1]) == -1 and int(t[2]) == -(2**63)


def test_device_init_uses_plain_version_on_cpu(hashes):
    kernels.reset_launches()
    h = hashes_as_int64(hashes[:100])
    assert torch.equal(device_init(h, 12, 5), device_init_plain(h, 12, 5))
    assert kernels.LAUNCHES["hash_init"] == 0
    assert device_init(h, 0).shape == (100, 0)


def test_graph_initial_state_on_cpu_is_the_host_init():
    import cleora_tpu as ct

    rng = np.random.default_rng(4)
    ref = ct.SparseMatrix.from_edge_arrays(rng.integers(0, 300, 900),
                                           rng.integers(0, 300, 900))
    g = from_jax_state(ref.__getstate__())
    got = g._initial_state(16, 3, torch.device("cpu"))
    assert got.numpy().tobytes() == ref.initialize_deterministically(
        16, 3).tobytes()
    # the device init from the cached hashes agrees bit for bit as well
    h = g._device_hashes(torch.device("cpu"))
    assert g._device_hashes(torch.device("cpu")) is h
    assert device_init_plain(h, 16, 3).numpy().tobytes() == got.numpy().tobytes()
