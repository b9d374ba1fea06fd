"""After which phase of ``chip_smoke.py`` a ``tracing.trace()`` session
stops recording the port's kernels.

    python scripts/torch_trace_bisect.py [--walk-parity]

Needs a CUDA card.  Runs ``chip_smoke.py``'s ``main()`` in this process
with each phase function wrapped: after the phase returns, one
``tracing.trace()`` session around one ``embed()`` iteration on phase 4's
graph (``chip_smoke.traced_embed_iteration``) prints one JSON line with the
phase's name, the kernel launches the trace names and how many of them are
K1 (``spmm_csr``).  The script then ends as ``chip_smoke.py`` does.
With ``--walk-parity`` it runs only phase 3's kernel checks and phase 4's
walk parity check, and traces after each call inside that check instead:
the walk kernels against plain, the counts, the PPMI check and each
``embed_deepwalk``/``embed_node2vec`` call (with its device and modes);
then it prints the kernels the first of those traces named and the last
one lost, and one session without the profiler's external correlation.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

PHASES = ("check_kernels", "slice_parity", "walk_parity", "full_width",
          "spectral_full_width", "walk_full_width", "node2vec_full_width",
          "retrieval_full_width", "node_classification", "streamed_sharded",
          "sharded_siblings", "walk_siblings_sharded")


def main() -> int:
    import torch

    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch.ops import cooccur

    seen = []

    def traced_after(name, real):
        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            span, kernels, events = cs.traced_embed_iteration()
            seen.append(kernels)
            label = name
            if "device" in kwargs:
                label += f" device={kwargs['device']}"
            label += "".join(f" {k}={kwargs[k]}" for k in
                             ("cooccurrence", "factorization") if k in kwargs)
            print(json.dumps({"after": label, "span": span,
                              "kernels": len(kernels),
                              "spmm_csr": sum("spmm_csr" in k
                                              for k in kernels)}),
                  flush=True)
            return out
        return call

    if "--walk-parity" not in sys.argv:
        for name in PHASES:
            setattr(cs, name, traced_after(name, getattr(cs, name)))
        return cs.main()
    for owner, name in ((cs, "walk_kernels_vs_plain"), (cs, "ppmi_vs_plain"),
                        (cooccur, "device_pair_counts"),
                        (alg, "embed_deepwalk"), (alg, "embed_node2vec")):
        setattr(owner, name, traced_after(name, getattr(owner, name)))
    dev = torch.device("cuda")
    cs.environment()
    cs.build_kernels()
    cs.check_kernels(dev)
    cs.walk_parity(dev)
    # the kernels the first trace named and the last one lost, and one more
    # session without the profiler's external correlation
    first, last = seen[0], seen[-1]
    lost = [k for k in sorted(set(first)) if first.count(k) > last.count(k)]
    print(json.dumps({"lost": [k[:80] for k in lost]}), flush=True)
    print(json.dumps({"no_external_correlation": k1_without_correlation(
        cs)}), flush=True)
    return 0


def k1_without_correlation(cs) -> dict:
    """One embed() iteration on phase 4's graph under a profiler session
    with ``disable_external_correlation``: the kernels its Chrome trace
    names and how many are K1."""
    import tempfile

    import cleora_tpu_torch as ctt
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    g = cs.random_graph(cs.PARITY_NODES, cs.PARITY_EDGES, seed=3)
    config = _ExperimentalConfig(disable_external_correlation=True)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     experimental_config=config) as prof:
            ctt.embed(g, feature_dim=cs.DIM, num_iterations=1)
            import torch
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            kernels = cs.trace_kernels(json.load(f)["traceEvents"])
    return {"kernels": len(kernels),
            "spmm_csr": sum("spmm_csr" in k for k in kernels)}


if __name__ == "__main__":
    sys.exit(main())
