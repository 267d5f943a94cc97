"""The merge collective of the distributed tools, on torch.distributed.

Only `replicate_rows` is ported so far: the shape of
wgatools_tpu/parallel/dist_tools.py::_replicate_rows, with which every
distributed tool exchanges its variable-length partials as padded byte
rows.  The tools themselves are still to port.
"""

import numpy as np
import torch
import torch.distributed as dist

from .mesh import RecordGroup


def replicate_rows(group: RecordGroup, row):
    """This rank's row (a 1-D host array, one length and dtype on every
    rank) -> every rank's row as a host array [D, L], in rank order, on
    every rank: ONE all_gather."""
    local = torch.from_numpy(np.ascontiguousarray(row).reshape(1, -1))
    local = local.to(group.device)
    out = torch.empty((group.size, local.shape[1]), dtype=local.dtype,
                      device=group.device)
    dist.all_gather_into_tensor(out, local, group=group.pg)
    return out.cpu().numpy()
