"""Spherical k-means (Lloyd) for the IVF index build (port of
tpu_rag/ops/kmeans.py).

Plain torch on whatever device the rows live on, as the JAX package leaves
these products to XLA: assignment is a chunked f32 matmul plus argmax (ties
to the lowest centroid: torch.argmax returns the first maximum), the update
a segment sum with index_add_, then renormalisation.  Empty clusters are
re-seeded from random rows.

The initial rows and the re-seeds are drawn from a torch.Generator seeded
with `seed`; its draws are not jax.random's, so the port trains other
centroids than the JAX package from the same seed.  Stores persist their
centroids, and parity runs on those.
"""

from __future__ import annotations

import numpy as np
import torch


def assign_clusters(x: torch.Tensor, centroids, *, chunk: int = 16384) -> torch.Tensor:
    """argmax_j <x_i, c_j>, computed in row chunks to bound memory.
    x: (n, d), centroids: (nlist, d) -> (n,) int32 on x's device."""
    c = torch.as_tensor(centroids, dtype=torch.float32).to(x.device)
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    for i in range(0, x.shape[0], chunk):
        scores = x[i:i + chunk].to(torch.float32) @ c.T
        out[i:i + chunk] = scores.argmax(dim=1)
    return out


def _update_centroids(x: torch.Tensor, assign: torch.Tensor, *, nlist: int):
    """Mean of each cluster's rows, renormalised; returns (centroids, counts)."""
    idx = assign.long()
    sums = torch.zeros((nlist, x.shape[1]), dtype=torch.float32,
                       device=x.device).index_add_(0, idx, x.to(torch.float32))
    counts = torch.zeros((nlist,), dtype=torch.float32, device=x.device).index_add_(
        0, idx, torch.ones((x.shape[0],), dtype=torch.float32, device=x.device))
    centroids = sums / counts.clamp(min=1.0)[:, None]
    # normalize (cosine geometry: spherical k-means)
    norms = torch.linalg.vector_norm(centroids, dim=1, keepdim=True)
    return centroids / norms.clamp(min=1e-12), counts


def kmeans(x, nlist: int, *, iters: int = 15, seed: int = 0, chunk: int = 16384):
    """Spherical k-means. Returns (centroids (nlist, d) f32, assign (n,) i32)
    as numpy arrays.

    x must be L2-normalized rows (FlatIndex/IVFIndex normalize at add time);
    a torch tensor is clustered on its own device.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[0]
    nlist = min(nlist, n)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    init_rows = torch.randperm(n, generator=gen, device=x.device)[:nlist]
    centroids = x[init_rows]

    for _ in range(iters):
        assign = assign_clusters(x, centroids, chunk=chunk)
        centroids, counts = _update_centroids(x, assign, nlist=nlist)
        # Re-seed empty clusters from random rows (host-side decision, cheap).
        empty = torch.nonzero(counts < 0.5).flatten()
        if len(empty):
            repl = torch.randperm(n, generator=gen, device=x.device)[:len(empty)]
            centroids[empty] = x[repl]
    assign = assign_clusters(x, centroids, chunk=chunk)
    return centroids.cpu().numpy(), assign.cpu().numpy()
