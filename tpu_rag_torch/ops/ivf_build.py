"""Device-side IVF list construction (port of tpu_rag/ops/ivf_build.py).

Builds the padded inverted lists on the device from the same tensor k-means
ran on, so the corpus is uploaded once per rebuild.

group_lists: stable-sort rows by cluster assignment, compute each row's slot
(rank within its cluster), scatter rows with slot < cap into the padded
(nlist, cap, ...) tensors; rows with slot >= cap are reported back via the
`fits`/`order` outputs so the caller can route them to the exact overflow
buffer.  Rows are scattered from where they lie (no sorted copy of x), which
writes the same tensors as the JAX function's scatter of x[order].
"""

from __future__ import annotations

import torch

from tpu_rag_torch.ops.topk import PAD_TAG


def group_lists(x, ns, canon, live_rows, assign, *, nlist: int, cap: int):
    """x: (n, d); ns/canon: (n,) i32; live_rows: (n,) i32 (live-row positions);
    assign: (n,) i32 cluster ids in [0, nlist).

    Returns (vec_lists (nlist, cap, d), ns_lists, canon_lists, row_lists,
    order (n,) i32, fits (n,) bool) — order/fits describe, in sorted order,
    which input rows landed in lists.
    """
    n, dev = x.shape[0], x.device
    assign = assign.to(torch.int64)
    order = torch.sort(assign, stable=True).indices
    sorted_assign = assign[order]
    starts = torch.searchsorted(sorted_assign, torch.arange(nlist, device=dev))
    slots = torch.arange(n, device=dev) - starts[sorted_assign]
    fits = slots < cap
    # overflow rows scatter into a sacrificial extra list (index nlist)
    li = torch.empty_like(order)
    si = torch.empty_like(order)
    li[order] = torch.where(fits, sorted_assign, nlist)
    si[order] = torch.where(fits, slots, 0)

    vec_lists = torch.zeros((nlist + 1, cap, x.shape[1]), dtype=x.dtype, device=dev)
    vec_lists[li, si] = x
    out = [vec_lists[:nlist]]
    for vals, fill in ((ns, PAD_TAG), (canon, PAD_TAG), (live_rows, -1)):
        t = torch.full((nlist + 1, cap), fill, dtype=torch.int32, device=dev)
        t[li, si] = vals.to(torch.int32)
        out.append(t[:nlist])
    return (*out, order.to(torch.int32), fits)
