"""The compositor's backward function: the gradient of the image to the
projected Gaussians' gradients.

FLOPs: every live pair (as the forward counts them) costs its
classification again (14) and its share of the gradients (the weight, the
colour and depth terms, the occlusion suffix, dL/dalpha, the exponent's
and the moments' sums, the transmittance: 42). Bytes: the projected rows
(11 floats) and the five gradient-image channels of every pixel read once,
and each valid Gaussian's gradient row (xy 2, conic 3, rgb 3, opacity,
depth: 10 floats) written once.
"""

OPS_PER_PAIR = 14 + 42
ROW_FLOATS = 11
GRAD_CHANNELS = 5
GRAD_FLOATS = 10


def flops(item: dict) -> float:
    return float(item["pairs"]) * OPS_PER_PAIR


def bytes_moved(item: dict) -> float:
    return 4.0 * (item["gaussians"] * (ROW_FLOATS + GRAD_FLOATS)
                  + item["pixels"] * GRAD_CHANNELS)
