"""Which engine and torch device the port runs on, and when the device path
pays off.

Two variables choose, as read by the command line (cli._device):

- WGA_TPU_DEVICE, the TPU package's switch (wgatools_tpu/core/device.py),
  read the same way: set to "", "0" or "false", the device branches run
  the host engine (device=None), and the process imports no torch.  Set to
  any other value, or unset, they run on a torch device: unlike the TPU
  package's auto mode, the device is the port's default.
- WGA_TORCH_DEVICE names that device: "cuda" (the default) or "cpu".  The
  CPU runs the plain PyTorch versions of the kernels and is meant for
  tests; it is chosen explicitly, never as a fallback: asking for CUDA
  where torch.cuda.is_available() is False raises.

Below DEVICE_MIN_COLUMNS aligned columns (MAF tools) or DEVICE_MIN_OPS op
slots (chain/PAF batches) a tool answers with the host engine: device
dispatch does not pay off on small inputs.  The values are the TPU
package's (wgatools_tpu/core/device.py), so both packages route alike.

This module imports torch only inside torch_device(), so the host route
never loads it.
"""

import os

# the device path pays off past this many alignment columns
DEVICE_MIN_COLUMNS = 1 << 22

# the same rule for op-table batches (chain_scan / segment-sum pipelines):
# ops are ~32 columns each, so this matches DEVICE_MIN_COLUMNS volume
DEVICE_MIN_OPS = 1 << 16

# batch capacity in columns (ops.batch and the MAF tools): a batch is
# flushed when its padded size would pass this (32 MiB of category plane per
# batch); here so that the tools read it without importing torch
DEFAULT_BATCH_COLUMNS = 64 << 20

DEVICE_ENV = "WGA_TORCH_DEVICE"
ROUTE_ENV = "WGA_TPU_DEVICE"
# the values of ROUTE_ENV that ask for the host engine (the TPU package's)
ROUTE_OFF = ("", "0", "false")

# the card's peaks behind every bound the port states (NVIDIA's data sheet,
# H100 SXM at 700 W): HBM bytes/s, and operations/s outside the tensor
# cores (the float32 rate; the kernels' integer work has no faster unit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def device_requested() -> bool:
    """False when WGA_TPU_DEVICE is set to "", "0" or "false": the user asks
    for the host engine.  True otherwise, unset included."""
    return os.environ.get(ROUTE_ENV) not in ROUTE_OFF


def torch_device():
    """The torch.device WGA_TORCH_DEVICE names."""
    import torch

    name = os.environ.get(DEVICE_ENV, "cuda")
    if name not in ("cuda", "cpu"):
        raise ValueError(f"{DEVICE_ENV}={name!r}: expected 'cuda' or 'cpu'")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{DEVICE_ENV}=cuda (the default) but torch.cuda.is_available() "
            f"is False; set {DEVICE_ENV}=cpu to run the plain PyTorch "
            "versions on the CPU"
        )
    return torch.device(name)
