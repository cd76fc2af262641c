"""The per-camera front end of plain 3D Gaussian Splatting: per free-xyz
Gaussian, its covariance from its scales and quaternion, its SH colour
(degree 3) and its EWA projection; no simulator.

FLOPs of the forward, a stated 407 a Gaussian: rotation 45 (the
quaternion's normalization 12 and its matrix 33), covariance 42 (the
squared scales 3, R scaled by them 9, six entries of R S^2 R^T at 5 each),
direction 10, SH basis and sum 136, projection 140, activations 34 (exp of
the scales, the opacity's sigmoid, the colour's + 0.5 and clamp).
"""

OPS_PER_GAUSSIAN = 45 + 42 + 10 + 136 + 140 + 34


def flops(gaussians: int) -> float:
    return float(gaussians) * OPS_PER_GAUSSIAN
