"""ssd_scan's bound (work/ssd_scan.py at 495 TFLOP/s or 3.35 TB/s) over the device time of its passes."""
from dndmbench import readers

LAYER = "SSD scan kernel (kernels/ssd_scan)"
UNIT = "%"
MOVES = "tokens_per_s"
SOURCE = "device_trace"
# the scan's passes, by a part of their names in the trace; a launch
# is counted by its output pass
KERNELS = ("ssd_output_kernel", "ssd_state_kernel", "ssd_carry_kernel")


def read(ctx):
    bound = readers.ssd_bound(ctx)
    return None if bound is None else readers.roofline(
        ctx, KERNELS, KERNELS[0], bound)
