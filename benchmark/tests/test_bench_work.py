"""Work counts against hand-computed values at one small shape each."""

import torch

from benchmark.harness import common, work


def test_flash_forward_work():
    # B 2, H 3, Sq 100, Sk 80 live, D 64
    flops, nbytes = work.flash_fwd_work(2, 3, 100, 80, 64)
    assert flops == 4 * 2 * 3 * 100 * 80 * 64
    # q and o: 2*3*100*64 each; k and v: 2*3*80*64 each; 2 bytes
    assert nbytes == 2 * (2 * 2 * 3 * 100 * 64 + 2 * 2 * 3 * 80 * 64)
    _, with_lse = work.flash_fwd_work(2, 3, 100, 80, 64, lse=True)
    assert with_lse == nbytes + 4 * 2 * 3 * 100


def test_flash_backward_work():
    flops, nbytes = work.flash_bwd_work(1, 2, 10, 10, 64)
    assert flops == 10 * 1 * 2 * 10 * 10 * 64
    # q k v o dO in, dq dk dv out: 8 tensors of 1*2*10*64; lse fp32
    assert nbytes == 2 * 8 * 2 * 10 * 64 + 4 * 2 * 10


def test_tconv3_work():
    # x [1, 4, 10, 32] -> 64 channels, a residual, per-video stats
    flops, nbytes = work.tconv3_work(1, 4, 10, 32, 64, True, True, False)
    m = 40
    assert flops == 2 * m * 3 * 32 * 64
    assert nbytes == (2 * (m * 32 + 2 * m * 64 + 3 * 32 * 64)
                      + 4 * (2 * 32 + 64) + 4 * 2 * 64)


def test_bound_takes_the_larger_side():
    assert common.bound_s(989e12, 0.0) == 1.0
    assert common.bound_s(0.0, 3.35e12) == 1.0
    assert common.bound_s(989e9, 3.35e12) == 1.0


def test_qk_ln_rope_backward_bytes():
    _, nbytes = work.qk_ln_rope_bwd_work(10, 5, 128)
    assert nbytes == 2 * 3 * 10 * 128 + 4 * 2 * 5 * 64


def test_flop_count_of_a_product_and_a_conv():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with work.FlopCount() as fc:
        a @ b
    assert fc.flops == 2 * 8 * 16 * 4
    x, w = torch.randn(1, 3, 6, 6), torch.randn(5, 3, 3, 3)
    with work.FlopCount() as fc:
        torch.nn.functional.conv2d(x, w, padding=1)
    assert fc.flops == 2 * 36 * 5 * 3 * 9
