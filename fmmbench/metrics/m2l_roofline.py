"""``m2l_roofline``: the M2L kernel (``csrc/m2l.cu``, both forms) at its
bound, in percent, summed over the L - 1 launches of an evaluation (levels
2 to L): p x p complex multiply-adds for each interaction pair of boxes
that both hold points, at the f32 product rate (three TF32 passes), or the
coefficients of those boxes read and written once, whichever is longer,
over its device time."""
from fmmbench.roofline import roofline


def read(trace: dict):
    return roofline(trace, "m2l", ("m2l_kernel", "m2l_wide_kernel"),
                    lambda d: int(d["level"]) - 1)
