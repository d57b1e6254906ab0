"""``p2p_roofline``: the P2P kernel (``csrc/p2p.cu``, both forms) at its
bound, in percent: bytes (z and q of each source, z of each passive
target, each target's output) or FP32 operations on the live pairs,
whichever is longer, over its device time; one launch an evaluation."""
from fmmbench.roofline import roofline


def read(trace: dict):
    return roofline(trace, "p2p", ("p2p_kernel", "p2p_stream_kernel"), lambda d: 1)
