"""Fused category-plane statistics + group-sum anchor scan.

The port of wgatools_tpu/ops/fused.py::classify_liftover_fused_adv16 in the
configuration bench.py times as the repo's headline metric
(catmode=True, scan_mode="once", raw_sums=True): one kernel reads the
category plane of a column batch AND the group-8 advance sums of the
matching op table, and returns the per-record counters plus the exclusive
group-prefix anchors of both directions.  Per-op offsets come from the
anchors on the host (liftover.expand_group_prefix, adv16_odd_offsets).

`classify_liftover_fused_adv16` launches kernel C (csrc/fused_adv16.cu) on
a CUDA device; `classify_liftover_fused_adv16_ref` is the plain PyTorch
version it is held against, and the one the CPU takes.
"""

import torch

from ..kernels import _build
from .classify import N_STATS, classify_stat_cat_ref


def classify_liftover_fused_adv16_ref(cw, lengths, st, sq, caller=False):
    """Plain PyTorch version of kernel C: (stats int32 [B, 8],
    t_anchor, q_anchor int32 [B2, NG])."""
    stats = classify_stat_cat_ref(cw, lengths, caller)
    t_anchor = torch.cumsum(st, dim=1, dtype=torch.int32) - st
    q_anchor = torch.cumsum(sq, dim=1, dtype=torch.int32) - sq
    return stats, t_anchor, q_anchor


def classify_liftover_fused_adv16(cw, lengths, st, sq, device, caller=False):
    """Counters of a category plane + anchors of its op table, in one pass.

    cw: int32 [B, LW] category plane (classify.pack_cat_nibbles); lengths:
    int32 [B] in columns; st, sq: int32 [B2, NG] raw group-8 advance sums
    (liftover.pack_ops_sums).  B2 may differ from B.  Arrays may be numpy
    or tensors; they are moved to `device`.  Returns (stats [B, 8],
    t_anchor [B2, NG], q_anchor [B2, NG]), int32 on `device`: kernel C on
    a CUDA device, the plain version on the CPU."""
    cw, lengths, st, sq = (
        torch.as_tensor(a, device=device) for a in (cw, lengths, st, sq)
    )
    if device.type == "cpu":
        return classify_liftover_fused_adv16_ref(cw, lengths, st, sq, caller)
    _build.check_cuda(cw, lengths, st, sq)
    if any(a.dtype != torch.int32 for a in (cw, lengths, st, sq)):
        raise ValueError("classify_liftover_fused_adv16 takes int32 inputs")
    B, LW = cw.shape
    B2, NG = st.shape
    if lengths.shape != (B,) or sq.shape != (B2, NG):
        raise ValueError(
            f"shapes cw {tuple(cw.shape)}, lengths {tuple(lengths.shape)}, "
            f"st {tuple(st.shape)}, sq {tuple(sq.shape)} do not agree"
        )
    if 8 * LW >= 2**31:
        raise ValueError("row width would wrap the int32 counters")
    stats = torch.zeros((B, N_STATS), dtype=torch.int32, device=device)
    t_anchor = torch.empty((B2, NG), dtype=torch.int32, device=device)
    q_anchor = torch.empty((B2, NG), dtype=torch.int32, device=device)
    _build.launch(
        "fused_adv16", cw, lengths, st, sq, stats, t_anchor, q_anchor,
        B, LW, B2, NG, int(caller),
    )
    return stats, t_anchor, q_anchor
