"""The backward of plain 3D Gaussian Splatting's per-camera front end: the
gradients of the projected Gaussians (screen mean, conic, colour, opacity)
back to each free-xyz Gaussian's position, SH coefficients, scales,
quaternion and opacity.

FLOPs: a stated 814 a Gaussian, twice the forward's 407
(``point_front_end``), the rule the benchmark takes for a backward pass
(each forward operation's two partial derivatives), as ``front_end``
takes it for the cloth field.
"""

from benchmark.counts import point_front_end

OPS_PER_GAUSSIAN = 2 * point_front_end.OPS_PER_GAUSSIAN


def flops(gaussians: int) -> float:
    return float(gaussians) * OPS_PER_GAUSSIAN
