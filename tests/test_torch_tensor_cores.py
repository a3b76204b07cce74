"""The plain version's model of the tensor cores' float32 accumulation
(``ops.shared_epoch.tc_accumulate``), on the CPU.

``tc_iteration_product`` sums the bfloat16 products of K1's reduced modes as
Hopper's tensor cores do, so that it gives the kernel's iterates bit for bit
(``tests/test_torch_kernels_cuda.py`` holds it to the kernel on the card);
the plain version (``iteration_product``) keeps float32 sums.  Here the model is held to an independent exact-rational
implementation of the same rule, and its k order and its closeness to the
plain version's float32 products are checked.
"""

from fractions import Fraction
import math

import numpy as np
import pytest
import torch

from osqp_tpu_torch.ops import shared_epoch as tse


def _bf16(x):
    return torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16).to(torch.float32)


def _rz_f32(v: Fraction) -> float:
    """``v`` rounded toward zero to float32."""
    if v == 0:
        return 0.0
    x = np.float32(float(v))  # nearest, then step toward zero if it overshot
    if abs(Fraction(float(x))) > abs(v):
        x = np.nextafter(x, np.float32(0))
    return float(x)


def _exp(x: float) -> int:
    return math.frexp(x)[1] - 1


def _reference(A, B):
    """The rule in exact rationals: each k step adds its products to the
    accumulator, every term cut toward zero to a multiple of 2^(e - 25), e
    the largest of the accumulator's exponent and the products' exponent
    sums, and rounds the sum toward zero to float32."""
    R, K = A.shape
    C = B.shape[1]
    out = np.zeros((R, C))
    for r in range(R):
        for c in range(C):
            acc = 0.0
            for k0 in range(0, K, tse.TC_K_STEP):
                terms = [(float(A[r, k]), float(B[k, c])) for k in range(k0, k0 + tse.TC_K_STEP)]
                exps = [_exp(a) + _exp(b) for a, b in terms if a * b != 0]
                if acc != 0:
                    exps.append(_exp(acc))
                if not exps:
                    continue
                q = Fraction(2) ** (max(exps) - tse.TC_ALIGN_BITS)

                def cut(v):
                    return math.trunc(v / q) * q

                s = cut(Fraction(acc)) + sum(cut(Fraction(a) * Fraction(b)) for a, b in terms)
                acc = _rz_f32(s)
            out[r, c] = acc
    return out


@pytest.mark.parametrize('seed, scale', [(0, 1.0), (1, 1e-3), (2, 37.0)])
def test_tc_accumulate_matches_exact_rule(seed, scale):
    """Random bfloat16 operands over several exponents, with zeros: the
    torch model equals the exact-rational rule bit for bit."""
    rng = np.random.default_rng(seed)
    R, K, C = 3, 48, 4
    A = _bf16(rng.standard_normal((R, K)) * scale * 2.0 ** rng.integers(-6, 6, (R, K)))
    B = _bf16(rng.standard_normal((K, C)) * 2.0 ** rng.integers(-6, 6, (K, C)))
    A[0, :5] = 0.0
    steps = [(A[:, k:k + tse.TC_K_STEP], B[k:k + tse.TC_K_STEP]) for k in range(0, K, 16)]
    got = tse.tc_accumulate(steps, R, C, 'cpu').double().numpy()
    np.testing.assert_array_equal(got, _reference(A.numpy(), B.numpy()))


def test_tc_accumulate_cuts_toward_zero():
    """Where the exact sum is not a float32, the model cuts toward zero
    (float32 round-to-nearest of the same sum rounds away from zero here)."""
    A = _bf16([[1.0, 2.0 ** -24 * 1.5] + [0.0] * 14])
    B = _bf16([[1.0], [1.0]] + [[0.0]] * 14)
    got = float(tse.tc_accumulate([(A, B)], 1, 1, 'cpu')[0, 0])
    assert got == 1.0  # 1 + 1.5 ulp/2 is cut to 1; nearest would be 1 + 2^-23
    assert float(np.float32(1.0 + 1.5 * 2.0 ** -24)) != 1.0


@pytest.mark.parametrize('n, m, wgmma', [(32, 48, True), (13, 19, True), (128, 192, False),
                                         (33, 10, False)])
def test_tc_k_order(n, m, wgmma):
    """The wgmma design's internal feature order where it runs (n <= 32, m
    <= 48: feature k at ``wg_positions``'s position, padding -1; at n = 32,
    m = 48 that is the natural order), else the natural order; both in
    whole k steps of 16, every feature once."""
    order = tse.tc_k_order(n, m, 2)
    assert len(order) % tse.TC_K_STEP == 0
    assert sorted(order[order >= 0].tolist()) == list(range(n + 2 * m))
    if wgmma:
        s_pos = tse.wg_positions(n, m, *tse._WG_PAD)[0]
        np.testing.assert_array_equal(order[s_pos], np.arange(n + 2 * m))
    else:
        np.testing.assert_array_equal(order[:n + 2 * m], np.arange(n + 2 * m))
    natural = bool((order[:n + 2 * m] == np.arange(n + 2 * m)).all())
    assert natural == ((n, m) != (13, 19))


@pytest.mark.parametrize('iter_prec', ['high', 'default'])
def test_tensor_core_product_close_to_float32_sums(iter_prec):
    """The tensor-core model (``tc_iteration_product``) and the plain
    version's float32 products of the same bfloat16 values
    (``iteration_product``) agree to the accumulation's rounding (a few
    ulps of the products' magnitudes), and differ; in 'highest' the two
    are one function."""
    rng = np.random.default_rng(3)
    n, m, B = 13, 19, 9
    F = torch.tensor(rng.standard_normal((n + m, n + 2 * m)), dtype=torch.float32)
    S = torch.tensor(rng.standard_normal((n + 2 * m, B)), dtype=torch.float32)
    tc = tse.tc_iteration_product(F, iter_prec)(S)
    f32 = tse.iteration_product(F, iter_prec)(S)
    scale = float((F.abs() @ S.abs()).max())
    assert float((tc - f32).abs().max()) <= 1e-6 * scale
    assert not torch.equal(tc, f32)
    assert torch.equal(tse.tc_iteration_product(F, 'highest')(S),
                       tse.iteration_product(F, 'highest')(S))
