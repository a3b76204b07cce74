"""The roofline counts on tiny shapes."""

from qpbench.harness import load_module
from qpbench.harness import HERE

k1 = load_module(HERE / 'metrics' / 'k1_roofline.py')
k6 = load_module(HERE / 'metrics' / 'k6_roofline.py')


def test_k1_counts():
    n, m = 2, 3
    assert k1.iteration_ops(n, m) == 2 * 5 * 8
    assert k1.check_ops(n, m) == 2 * 5 * 2 + 2 * 3 * 2
    # two instances: 25 iterations (one epoch), 30 (two epochs); 3 launches
    ops, nbytes = k1.work([25, 30], 3, n, m, 25, 4)
    assert ops == 55 * 80 + 3 * 32
    state = (n + 2 * m) + n + m
    assert nbytes == 3 * 5 * 8 * 4 + 3 * 2 * state * 4


def test_k6_bytes():
    assert k6.launch_bytes(10, 4) == 8 * 10 + 2 * 8 * 4
