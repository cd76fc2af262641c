"""A MeshGraphNet forward pass over a graph of ``nodes`` nodes and
``edges`` directed edges: 2 rows in out for every Linear layer (the
encoders' node and edge MLPs, each message-passing layer's edge MLP over
the edges and node MLP over the nodes, the decoder). LayerNorm, the
gathers and the sums are not counted. A training step costs three
forwards (the backward twice the forward) per unroll step.
"""


def linear_flops(rows: int, sizes: list) -> float:
    return 2.0 * rows * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))


def flops(sizes: dict, nodes: int, edges: int) -> float:
    """``sizes``: each MLP's layer sizes by its path (encoder/node, ...)."""
    total = 0.0
    for path, s in sizes.items():
        total += linear_flops(edges if path.endswith("edge") else nodes, s)
    return total
