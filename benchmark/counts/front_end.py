"""The per-camera front end of the splatting render: the residual
simulator MLP and, per Gaussian, its barycentric mean, its face-carried
rotation, its covariance, its SH colour (degree 3) and its EWA projection.

FLOPs of the forward: 2 in out for each of the MLP's three layers (13 ->
256 -> 256 -> 3V), and a stated 430 a Gaussian (mean 20, rotation 45,
covariance 45, direction 10, SH basis and sum 136, projection 140,
activations 34). A training step's backward costs twice its forward.
"""

OPS_PER_GAUSSIAN = 430
HIDDEN = 256
ENCODING = 13


def flops(gaussians: int, vertices: int) -> float:
    mlp = 2.0 * (ENCODING * HIDDEN + HIDDEN * HIDDEN + HIDDEN * 3 * vertices)
    return mlp + float(gaussians) * OPS_PER_GAUSSIAN
