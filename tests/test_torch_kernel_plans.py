"""The host-side choices of two CUDA kernels, as plain functions on the CPU:
the tensor-core probe's plan of work items (`utils/mma_probe.plan`: output
tile width and K split) and the row quantizer's load width
(`ops/quant_fused.load_width`). The kernels themselves run only on the
card (tests/test_torch_kernels_cuda.py); what they are given is decided
here, so its rules are checked here: every plan is one the kernel takes,
every reference probe shape fills the card, and a load width never
outruns the row length or an operand's alignment.
"""

import pytest

from umfa_tpu_torch.ops.quant_fused import load_width
from umfa_tpu_torch.utils import mma_probe as mp


def _check_plan(m, k, n):
    tn, split = mp.plan(m, k, n)
    assert tn in mp.STEPS and n % tn == 0
    assert split >= 1 and k % split == 0
    ks = k // split
    assert ks % 16 == 0 and ks // 16 in mp.STEPS[tn]  # a slice the kernel is built for
    return tn, split, (m // mp.TILE) * (n // tn) * split


@pytest.mark.parametrize("name", sorted(mp.SHAPES))
def test_probe_plan_fills_the_card_at_the_reference_shapes(name):
    m, k, n = mp.SHAPES[name]
    tn, split, items = _check_plan(m, k, n)
    assert items >= mp.MIN_ITEMS
    assert split * (k // split) == k  # the slices sum to K


@pytest.mark.parametrize("name", sorted(mp.SHAPES))
def test_probe_plan_takes_the_fewest_slices(name):
    m, k, n = mp.SHAPES[name]
    tn, split, items = _check_plan(m, k, n)
    tiles = (m // mp.TILE) * (n // tn)
    # No plan with fewer slices (larger slices the kernel takes) reaches
    # MIN_ITEMS: each smaller split is either too few items or too deep.
    for st in mp.STEPS[tn]:
        sp = k // (16 * st)
        if k % (16 * st) == 0 and sp < split:
            assert tiles * sp < mp.MIN_ITEMS


@pytest.mark.parametrize("m,k,n", [
    (64, 16, 64), (64, 48, 64), (128, 16, 128), (256, 1024, 192), (4096, 512, 256),
    (64, 4096, 128), (192, 144, 320), (2048, 896, 64),
])
def test_probe_plan_is_one_the_kernel_takes(m, k, n):
    tn, split, items = _check_plan(m, k, n)
    assert tn == (128 if n % 128 == 0 else 64)
    tiles = (m // mp.TILE) * (n // tn)
    # Where the tiles cannot reach MIN_ITEMS, the plan splits as far as it can.
    if items < mp.MIN_ITEMS:
        assert k // split == 16
    if tiles >= mp.MIN_ITEMS:
        assert k // split // 16 == max(st for st in mp.STEPS[tn] if k % (16 * st) == 0)


@pytest.mark.parametrize("m,k,n", [(100, 64, 64), (64, 40, 64), (64, 64, 96), (64, 0, 64),
                                   (64, mp.MAX_K + 16, 64)])
def test_probe_plan_refuses_what_the_kernel_does_not_take(m, k, n):
    with pytest.raises(ValueError, match="multiple"):
        mp.plan(m, k, n)


@pytest.mark.parametrize("d,itemsize,x_off,mean_off,want", [
    (64, 2, 0, 0, 8),      # bf16, 16-byte rows in flight
    (64, 4, 0, 0, 4),      # fp32
    (72, 2, 0, 0, 8),      # 144-byte rows: still 16-byte aligned
    (48, 2, 0, 0, 8),
    (36, 2, 0, 0, 4),      # 72-byte rows: 8-byte loads
    (255, 2, 0, 0, 1),     # odd rows: element loads
    (1, 4, 0, 0, 1),
    (256, 2, 2, 0, 1),     # a storage offset of one bf16
    (256, 2, 8, 0, 4),     # of four bf16
    (256, 4, 4, 0, 1),     # of one float
    (64, 2, 0, 4, 1),      # the mean one float off: element loads of it, so of x too
    (64, 2, 0, 8, 2),
    (128, 4, 0, 16, 4),
])
def test_quant_rows_load_width(d, itemsize, x_off, mean_off, want):
    base = 1 << 20  # an allocation's address: 512-byte aligned
    assert load_width(d, itemsize, base + x_off, base + mean_off) == want
    # Without a mean only x's row length and alignment count.
    free = load_width(d, itemsize, base + x_off)
    assert free >= want and d % free == 0 and (base + x_off) % (free * itemsize) == 0
    assert free * itemsize <= 16
