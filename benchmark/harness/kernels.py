"""Kernel B1 in a device trace: csrc/vocoder.cu's ada_snake_conv kernels,
and the reduction of the statistics partials that the op launches right
after a launch that returns them."""

import re

B1 = re.compile(r"ada_snake_conv")
REDUCE = re.compile(r"reduce_kernel")


def b1_seconds(trace) -> float:
    """Device seconds of B1's launches and of the statistics reduction
    that directly follows one."""
    total, after_b1 = 0.0, False
    for name, _, dur in trace.ops:
        if B1.search(name):
            total += dur
            after_b1 = True
        elif after_b1 and REDUCE.search(name):
            total += dur
            after_b1 = False
        else:
            after_b1 = False
    return total
