"""The compositor's forward function: projected Gaussians to an image.

FLOPs: every (pixel, Gaussian) pair that the reference finds live before
the pixel's transmittance falls to 1e-4 costs its classification (offsets,
the quadratic form, exp, the opacity product and the clamp: 14) and its
compositing (the weight, three colour and one depth multiply-add, the
alpha sum and the transmittance update: 13). Bytes: each valid Gaussian's
projected row (x, y, conic 3, rgb 3, opacity, depth, power cut: 11 floats)
read once and the five output channels of every pixel (rgb, depth, alpha)
written once.
"""

OPS_PER_PAIR = 14 + 13
ROW_FLOATS = 11
OUT_CHANNELS = 5


def flops(item: dict) -> float:
    return float(item["pairs"]) * OPS_PER_PAIR


def bytes_moved(item: dict) -> float:
    return 4.0 * (item["gaussians"] * ROW_FLOATS + item["pixels"] * OUT_CHANNELS)
