"""PCA whitening.

Reference semantics: ``whiten_embeddings`` (pycleora/__init__.py:130-164):
mean-center, D×D covariance with 1/(n-1), eigendecomposition sorted by
descending eigenvalue, scale columns by 1/sqrt(max(λ, 1e-10)), project
(PCA whitening — projection onto principal components, NOT rotated back).

The two products are plain float32 ``torch.matmul`` calls and the D×D
eigendecomposition is ``torch.linalg.eigh`` (which waits for the device).
The products run in full float32 even when the caller has allowed TF32
(:func:`.._util.full_float32_matmul`), as the JAX version pins them.  Column
signs of eigh may differ between backends — inner products and distances
are invariant to them.
"""

from __future__ import annotations

import torch

from .._util import full_float32_matmul


@full_float32_matmul()
def whiten(x: torch.Tensor, n_components=None, eps: float = 1e-10) -> torch.Tensor:
    n = x.shape[0]
    if n <= 1:
        return x
    xf = x.float()
    # the mean as a sum over n: the sharded loop all-reduces the same sum
    # (parallel/embed.py), so one shard of it equals this bit for bit
    xc = xf - xf.sum(dim=0) / n
    cov = torch.matmul(xc.T, xc) / (n - 1)
    eigenvalues, eigenvectors = torch.linalg.eigh(cov)
    # eigh returns ascending; reference sorts descending
    eigenvalues = eigenvalues.flip(0)
    eigenvectors = eigenvectors.flip(1)
    if n_components is not None:
        eigenvalues = eigenvalues[:n_components]
        eigenvectors = eigenvectors[:, :n_components]
    scale = 1.0 / torch.sqrt(torch.clamp_min(eigenvalues, eps))
    out = torch.matmul(xc, eigenvectors * scale)
    return out.to(x.dtype)
