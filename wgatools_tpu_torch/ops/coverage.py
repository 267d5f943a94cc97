"""Interval coverage as a difference-array scatter (reference:
src/tools/pafcov.rs).

The port of wgatools_tpu/ops/coverage.py: +1 at span starts, -1 at span
ends, then a prefix sum.  These were XLA scatters, not Pallas kernels, in
the TPU package; here they are `index_add_` and `cumsum` on the tensors'
device.  JAX's donated difference array becomes an update in place.
"""

import torch


def scatter_spans(diff, starts, ends, valid=None):
    """Add spans into the int32 difference array diff [n + 1] in place and
    return it: +1 at each start, -1 at each end, both clipped to [0, n].
    valid: int32 0/1 per span, or None for all spans (the TPU package's
    scatter_spans; pafcov's batches pass starts >= 0)."""
    n = diff.shape[0] - 1
    if valid is None:
        valid = torch.ones(starts.shape, dtype=torch.int32, device=diff.device)
    diff.index_add_(0, starts.clamp(0, n).long(), valid)
    diff.index_add_(0, ends.clamp(0, n).long(), -valid)
    return diff


def diff_to_coverage(diff):
    """Prefix-sum a difference array [n + 1] into int32 coverage [n]."""
    return torch.cumsum(diff[:-1], dim=0, dtype=torch.int32)
