"""The count functions on shapes small enough to count by hand."""

from benchmark.counts import compositor_backward, compositor_forward, front_end, mgn_forward
from benchmark.harness import graphs
from benchmark.tests import tiny


def test_compositor_counts():
    item = {"pairs": 10, "gaussians": 3, "pixels": 4}
    assert compositor_forward.flops(item) == 10 * 27
    assert compositor_forward.bytes_moved(item) == 4 * (3 * 11 + 4 * 5)
    assert compositor_backward.flops(item) == 10 * 56
    assert compositor_backward.bytes_moved(item) == 4 * (3 * 21 + 4 * 5)


def test_front_end_counts():
    # MLP 13 -> 256 -> 256 -> 6 (two vertices) and 5 Gaussians at 430
    assert front_end.flops(5, 2) == 2 * (13 * 256 + 256 * 256 + 256 * 6) + 5 * 430


def test_linear_and_gnn_counts():
    assert mgn_forward.linear_flops(3, [2, 4, 1]) == 2 * 3 * (2 * 4 + 4 * 1)
    sizes = {"encoder/node": [2, 3], "encoder/edge": [1, 3], "processor/0/edge": [9, 3],
             "processor/0/node": [6, 3], "decoder": [3, 1]}
    nodes, edges = 5, 7
    hand = 2 * (5 * 2 * 3 + 7 * 1 * 3 + 7 * 9 * 3 + 5 * 6 * 3 + 5 * 3 * 1)
    assert mgn_forward.flops(sizes, nodes, edges) == hand


def test_mlp_sizes_of_the_published_widths():
    sizes = graphs.mlp_sizes(tiny.load("configs", "mgn-15x128")["network"])
    assert sizes["processor/0/edge"] == [384, 128, 128, 128]
    assert sizes["processor/14/node"] == [256, 128, 128, 128]
    assert sizes["encoder/node"] == [8, 128, 128, 128]
    assert sizes["decoder"] == [128, 128, 128, 3]
    assert len(sizes) == 2 + 2 * 15 + 1
