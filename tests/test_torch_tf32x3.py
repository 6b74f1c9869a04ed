"""The precision argument of the 3xTF32 score tile (csrc/tf32x3_tile.cuh), on the CPU.

The tile splits each f32 operand x into hi = tf32(x) and lo = tf32(x - hi), where
tf32() rounds to 10 mantissa bits (13 dropped), to nearest, ties away from zero, as
PTX's `cvt.rna.tf32.f32` does (the kernel adds half of the dropped range to the bits
and clears them, as `to_tf32` below), and sums hi.lo + lo.hi + hi.hi for each product.
These tests emulate that split in torch and check what K9's precision contract rests
on:

* hi + lo reconstructs x to within 2^-22 |x|;
* on multiples of 1/8, lo is 0 and the 3-product score is exact;
* on unit vectors, the 3-product score (products and sums in f64, i.e. the split's own
  error) is within 2^-20 sum_d |q_d e_d| of the f64 score: under 1e-6, far inside
  the card tests' 1e-5 (which also covers f32 accumulation) and the packed key's 2^-12.
"""
import numpy as np
import pytest
import torch

_DROPPED = 13  # f32 has 23 mantissa bits, TF32 10


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's `to_tf32` on finite f32 values: add half of the dropped range to the
    bits, which adds it to the magnitude (a carry reaches the exponent as it should),
    then clear the dropped bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (1 << (_DROPPED - 1))) & ~((1 << _DROPPED) - 1)).view(torch.float32)


def split(x: torch.Tensor):
    hi = to_tf32(x)
    return hi, to_tf32(x - hi)  # x - hi is exact in f32


def score3(q: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """[B, N] 3xTF32 scores of f32 q [B, d] and e [N, d], products and sums in f64."""
    (qh, ql), (eh, el) = split(q), split(e)
    qh, ql, eh, el = (t.double() for t in (qh, ql, eh, el))
    return qh @ el.T + ql @ eh.T + qh @ eh.T


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),             # a tie rounds away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),             # just below the tie rounds down
    (1.0 + 3 * 2.0**-11, 1.0 + 2.0**-9),          # a tie above an odd last bit, away too
    (2.0 - 2.0**-23, 2.0),                        # the carry reaches the exponent
    (1.0 - 2.0**-12, 1.0),                        # a tie one binade down, up to the next
    (0.125, 0.125),
])
def test_cvt_rna_emulation(x, want):
    got = to_tf32(torch.tensor([x], dtype=torch.float32))
    assert float(got) == want
    assert int(got.view(torch.int32)) & ((1 << _DROPPED) - 1) == 0


@pytest.mark.parametrize("seed,scale", [(0, 0), (1, -30), (2, 30), (3, -60)])
def test_split_reconstructs_x(seed, scale):
    """Within 2^-22 |x| wherever lo is a normal number (|x| above about 2^-100)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(100_000) * 2.0**scale).astype(np.float32)
    x[:4] = (1.0 + 2.0**-11, -(1.0 + 2.0**-11), 2.0**-12 + 2.0**-24, 0.0)
    t = torch.from_numpy(x)
    hi, lo = split(t)
    assert bool((hi.view(torch.int32) & 0x1FFF == 0).all()) and bool((lo.view(torch.int32) & 0x1FFF == 0).all())
    err = (hi.double() + lo.double() - t.double()).abs()
    assert bool((err <= 2.0**-22 * t.double().abs()).all())


@pytest.mark.parametrize("d", [37, 96, 384])
def test_lo_is_zero_and_score_exact_on_the_eighths_grid(d):
    rng = np.random.default_rng(d)
    q = torch.from_numpy((rng.integers(-8, 9, (16, d)) / 8.0).astype(np.float32))
    e = torch.from_numpy((rng.integers(-8, 9, (512, d)) / 8.0).astype(np.float32))
    for x in (q, e):
        hi, lo = split(x)
        assert torch.equal(hi, x) and bool((lo == 0).all())
    s = score3(q, e)
    assert torch.equal(s, q.double() @ e.double().T)
    assert torch.equal(s.float().double(), s)  # the exact sums are f32 values too


@pytest.mark.parametrize("d", [96, 384])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_error_on_unit_vectors(d, seed):
    rng = np.random.default_rng(seed * 1000 + d)

    def unit(rows):
        x = rng.standard_normal((rows, d))
        return torch.from_numpy((x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32))

    q, e = unit(64), unit(2048)
    exact = q.double() @ e.double().T
    err = (score3(q, e) - exact).abs()
    scale = q.double().abs() @ e.double().abs().T
    assert bool((err <= 2.0**-20 * scale).all())
    assert float(err.max()) < 1e-6
    # the bf16 route: widened bf16 values are TF32 values, so one product is exact
    qb, eb = q.bfloat16().float(), e.bfloat16().float()
    assert torch.equal(split(qb)[0], qb) and bool((split(eb)[1] == 0).all())
