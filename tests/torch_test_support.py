"""Fixtures and helpers shared by the port's test modules
(``tests/test_torch_*.py``).  Imports neither JAX nor the JAX package, so
``tests/test_torch_kernels.py`` still runs where JAX is not installed.

* :func:`one_torch_thread`, imported by every port test module (pytest
  takes a fixture from the module's namespace): torch runs on one thread
  in each test.  The suite runs in several xdist workers on a few cores,
  and the plain versions' OpenMP threads (eight a process) spinning in
  each of them made small tests hundreds of times slower than alone.  The
  native graph builders of both packages set the process's OpenMP count
  to their worker count (``native/builder.cpp``), so the count is set
  again after every build the test makes, and once more after the
  module's fixtures (which run before this one).
* :func:`once`: a fixture's output made once per test session and shared
  by every xdist worker (``--dist load`` spreads a module's tests over the
  workers, and each would otherwise repeat a module fixture's rank runs
  and JAX references).
"""

from __future__ import annotations

import os
import pickle
import sys
import time

import pytest
import torch

_BUILDERS = {
    "cleora_tpu_torch.graph.native": ("build_graph_native",
                                      "build_graph_native_files"),
    "cleora_tpu.graph.native": ("build_graph_native",
                                "build_graph_native_files"),
}


@pytest.fixture(autouse=True)
def one_torch_thread(monkeypatch):
    """torch on one thread for the test, again after each native graph
    build it makes; the count the test found is restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for module, names in _BUILDERS.items():
        mod = sys.modules.get(module)  # a package not imported builds none
        for name in names if mod is not None else ():
            monkeypatch.setattr(mod, name, _repinned(getattr(mod, name)))
    yield
    torch.set_num_threads(threads)


def _repinned(build):
    def call(*args, **kwargs):
        try:
            return build(*args, **kwargs)
        finally:
            torch.set_num_threads(1)
    return call


WAIT_S = 600


def once(tmp_path_factory, name: str, produce):
    """The directory into which ``produce(directory)`` wrote, run once per
    test session: under pytest-xdist the first worker to ask runs it and
    the others wait for its result (pytest-xdist's recipe for a session
    fixture: a lock file in the workers' common temporary directory)."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        out = tmp_path_factory.mktemp(name)
        produce(out)
        return out
    out = tmp_path_factory.getbasetemp().parent / name
    try:
        os.close(os.open(f"{out}.lock", os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        deadline = time.monotonic() + WAIT_S
        while not (out / "done").exists():
            if (out / "failed").exists():
                pytest.fail(f"{name} failed in another worker:\n"
                            + (out / "failed").read_text())
            assert time.monotonic() < deadline, f"{name}: no result"
            time.sleep(0.2)
        return out
    out.mkdir()
    try:
        produce(out)
    except BaseException as err:
        (out / "failed").write_text(repr(err))
        raise
    (out / "done").touch()
    return out


def once_value(tmp_path_factory, name: str, compute):
    """``compute()``'s value (picklable), computed once per test session
    as :func:`once` and read back by every worker."""
    def produce(out):
        with open(out / "value.pkl", "wb") as f:
            pickle.dump(compute(), f)

    with open(once(tmp_path_factory, name, produce) / "value.pkl",
              "rb") as f:
        return pickle.load(f)
