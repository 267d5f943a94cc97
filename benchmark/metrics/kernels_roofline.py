"""The share of the roofline that the path's kernels reach, in %: the
input's work bytes under the cell's model (benchmark/workloads/<cell>.json)
at the card's peak bandwidth, over the device time of every kernel in the
traced window that is not a copy (NCCL's collectives count as copies), per
call.  The work is the input's, whatever tensors the program launches on."""

import harness


def read(run):
    kernel_s = run.device.get("kernel_s", 0.0)
    if not kernel_s or not run.samples:
        return None
    per_call = kernel_s / len(run.samples)
    bound = harness.work_bytes(run.spec["work"]["work_bytes"], run.counts) \
        / harness.PEAK_BYTES_PER_S
    return bound / per_call * 100
