"""The fused forward step of the CIGAR engine, on the port's device.

The counterpart of __graft_entry__.entry: column classify + statistics of a
pair of byte planes AND the liftover scan of 16-bit packed op words
(liftover.pack_ops_words16), in one step.  On a CUDA device the step is one
launch of kernel F (ops.fused.classify_liftover_fused16, csrc/fused16.cu)
on the int32 byte-word views of the planes; on the CPU it is F's plain
version.

    step, args = entry()        # the device of core.device.torch_device()
    stats, t_even, t_odd, q_even, q_odd = step(*args)
"""

import numpy as np
import torch

from .core.device import torch_device
from .ops.classify import pack_pairs
from .ops.fused import classify_liftover_fused16
from .ops.liftover import pack_ops_batch, pack_ops_words16


def fused_step(t, q, lengths, opw):
    """(stats int32 [B, 8], t_even, t_odd, q_even, q_odd int32 [B2, NOH])
    of uint8 byte planes t, q [B, L] (L a multiple of 4), int32 lengths [B]
    and packed16 op words opw [B2, NOH], on the planes' device.  The planes
    go to kernel F as their int32 byte words [B, L/4], views that share
    their memory."""
    return classify_liftover_fused16(t.view(torch.int32), q.view(torch.int32),
                                     lengths, opw, t.device)


def entry_inputs():
    """The TPU entry's host inputs, from seed 0 in its order of draws: 4
    pairs of 200-511 columns over ACGT- (uint8 [4, L], L padded to a
    multiple of 128 with gap/gap), their int32 lengths, and 24 ops of
    M=XID with lengths 1-63 per record as packed16 words int32 [4, 64]."""
    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(4):
        n = int(rng.integers(200, 512))
        t = rng.choice(list(b"ACGT-"), size=n).astype(np.uint8).tobytes()
        q = rng.choice(list(b"ACGT-"), size=n).astype(np.uint8).tobytes()
        pairs.append((t, q))
    t, q, lens = pack_pairs(pairs)
    op_chars = np.frombuffer(b"M=XID", np.uint8)
    ops, oplens = pack_ops_batch(
        [op_chars[rng.integers(0, 5, 24)] for _ in range(4)],
        [rng.integers(1, 64, 24) for _ in range(4)],
    )
    return t, q, lens, pack_ops_words16(ops, oplens)


def entry(device=None):
    """(step, args): fused_step and its inputs (entry_inputs) as tensors on
    `device` (default: core.device.torch_device(), the card unless
    WGA_TORCH_DEVICE=cpu).  step(*args) returns the five outputs of the
    TPU entry's `combined`."""
    device = torch_device() if device is None else torch.device(device)
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in entry_inputs())
    return fused_step, args
