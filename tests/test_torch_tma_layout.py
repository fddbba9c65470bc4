"""The numbers the wrapper hands the CUDA side to build its TMA tensor maps
(`tma_layout`, `fwd_layout`, `dq_layout`, `dkv_layout`), and what it
refuses, on CPU tensors: the maps are encoded from these numbers on the
card, so a wrong stride or box here would read the wrong rows there."""

import pytest
import torch

from ray_tpu_torch.ops.cuda import flash_attention as flash

BF16 = torch.bfloat16
BOX_COLS = 64  # 128-byte swizzle: 64 bf16 columns
# The tiles the libraries report (`flash.kernel_tiles`, which needs the
# card): box rows of each operand in launch order, then the box columns.
FWD_TILES = (128, 128, 128, 64, BOX_COLS)  # q, k, v, o
DQ_TILES = (128, 64, 64, 128, BOX_COLS)  # q, k, v, dO
DKV_TILES = (64, 128, 128, 64, BOX_COLS)  # q, k, v, dO


def test_contiguous_layout_dims_strides_box():
    q = torch.empty((2, 200, 16, 128), dtype=BF16)
    # dims innermost first; byte strides of S, H, B; box of 64 columns.
    assert flash.tma_layout(q, 128, BOX_COLS) == (128, 200, 16, 2, 16 * 128 * 2, 128 * 2,
                                        200 * 16 * 128 * 2, 64, 128)


def test_gqa_kv_layout():
    k = torch.empty((2, 200, 4, 128), dtype=BF16)
    assert flash.tma_layout(k, 128, BOX_COLS) == (128, 200, 4, 2, 4 * 128 * 2, 128 * 2,
                                        200 * 4 * 128 * 2, 64, 128)


def test_permuted_do_is_read_by_its_strides():
    """A [B, H, S, D] tensor viewed as [B, S, H, D], as autograd may hand dO
    over: the map follows its strides, no copy."""
    do = torch.empty((2, 16, 200, 128), dtype=BF16).transpose(1, 2)
    assert do.shape == (2, 200, 16, 128)
    assert flash.tma_layout(do, 64, BOX_COLS) == (128, 200, 16, 2, 128 * 2, 200 * 128 * 2,
                                        16 * 200 * 128 * 2, 64, 64)


def test_head_dim_64_is_one_box_wide():
    t = torch.empty((3, 64, 4, 64), dtype=BF16)
    assert flash.tma_layout(t, 128, BOX_COLS) == (64, 64, 4, 3, 4 * 64 * 2, 64 * 2,
                                        64 * 4 * 64 * 2, 64, 128)


def test_size_one_dims_get_a_usable_stride():
    """A size-1 dim's stride is never used; it is given the stride a
    contiguous tensor would have, whatever the view says."""
    t = torch.empty((1, 64, 4, 128), dtype=BF16).as_strided((1, 64, 4, 128), (3, 512, 128, 1))
    assert flash.tma_layout(t, 128, BOX_COLS) == (128, 64, 4, 1, 1024, 256, 256 * 4, 64, 128)
    one = torch.empty((2, 1, 4, 128), dtype=BF16)
    assert flash.tma_layout(one, 64, BOX_COLS)[4] == 128 * 2  # S stride: one row of D


@pytest.mark.parametrize(
    "make",
    [
        # row stride of 132 bf16 (264 bytes) is not a multiple of 16
        lambda: torch.empty((2, 64, 4, 132), dtype=BF16)[..., :128],
        # base address 2 bytes past an aligned one
        lambda: torch.empty((2 * 64 * 4 * 128 + 1,), dtype=BF16)[1:].view(2, 64, 4, 128),
        # strided last dim
        lambda: torch.empty((2, 64, 4, 256), dtype=BF16)[..., ::2],
        # not bf16
        lambda: torch.empty((2, 64, 4, 128), dtype=torch.float32),
        # broadcast along S (stride 0), as the gradient of o.sum(1) comes
        lambda: torch.empty((2, 1, 4, 128), dtype=BF16).expand(2, 64, 4, 128),
    ],
    ids=["misaligned_row_stride", "misaligned_base", "strided_last_dim", "f32", "broadcast_s"],
)
def test_layout_refuses_what_tma_cannot_read(make):
    with pytest.raises(ValueError):
        flash.tma_layout(make(), 128, BOX_COLS)


def test_kernel_layouts_tiles_grids_and_order():
    b, s, h, hkv, d = 2, 1000, 16, 4, 128
    q = torch.empty((b, s, h, d), dtype=BF16)
    k = torch.empty((b, s, hkv, d), dtype=BF16)
    do = torch.empty((b, h, s, d), dtype=BF16).transpose(1, 2)
    # B1: a 128-row q tile per block (the q box), 128-row kv tiles streamed,
    # o stored 64 rows a warpgroup; a block per q tile of each (b, h).
    fwd = flash.fwd_layout(q, k, k, q, FWD_TILES)
    assert list(fwd.maps) == ["q", "k", "v", "o"]
    assert [m[8] for m in fwd.maps.values()] == [128, 128, 128, 64]
    assert fwd.blocks == b * h * 8
    # B2: a 128-row q tile per block (the q and dO boxes), 64-row kv tiles
    # streamed; a block per q tile of each (b, h), the 104-row tail included.
    dq = flash.dq_layout(q, k, k, do, DQ_TILES)
    assert list(dq.maps) == ["q", "k", "v", "do"]
    assert [m[8] for m in dq.maps.values()] == [128, 64, 64, 128]
    assert dq.maps["k"][:4] == (d, s, hkv, b)
    assert dq.blocks == b * h * 8
    assert list(dq.array())[27:] == [*flash.tma_layout(do, 128, BOX_COLS), dq.blocks]
    # B3: a 128-row kv tile per block, 64-row q and dO tiles streamed; a
    # block per kv tile of each (b, h_kv).
    dkv = flash.dkv_layout(q, k, k, do, DKV_TILES)
    assert list(dkv.maps) == ["q", "k", "v", "do"]
    assert [m[8] for m in dkv.maps.values()] == [64, 128, 128, 64]
    assert dkv.blocks == b * hkv * 8
    # What the CUDA side reads: the maps' numbers in order, then the blocks.
    flat = list(dkv.array())
    assert len(flat) == 4 * 9 + 1
    assert flat[27:36] == list(flash.tma_layout(do, 64, BOX_COLS))
    assert flat[-1] == dkv.blocks


@pytest.mark.parametrize("s,blocks", [(1, 1), (128, 1), (129, 2), (300, 3), (1024, 8)])
def test_grids_have_one_block_per_tile_of_each_head(s, blocks):
    """Ragged tails get a block of their own."""
    q = torch.empty((2, s, 4, 64), dtype=BF16)
    k = torch.empty((2, s, 2, 64), dtype=BF16)
    assert flash.fwd_layout(q, k, k, q, FWD_TILES).blocks == 2 * 4 * blocks
    assert flash.dq_layout(q, k, k, q, DQ_TILES).blocks == 2 * 4 * blocks
    assert flash.dkv_layout(q, k, k, q, DKV_TILES).blocks == 2 * 2 * blocks


def test_kernel_layouts_raise_on_an_unreadable_operand():
    q = torch.empty((1, 64, 2, 128), dtype=BF16)
    bad = torch.empty((1, 64, 2, 132), dtype=BF16)[..., :128]
    with pytest.raises(ValueError):
        flash.fwd_layout(q, bad, q, q, FWD_TILES)
    with pytest.raises(ValueError):
        flash.dq_layout(q, q, bad, q, DQ_TILES)
    with pytest.raises(ValueError):
        flash.dkv_layout(q, q, q, bad, DKV_TILES)


@pytest.mark.parametrize("dtype,rows", [(BF16, 64), (torch.float32, 16)])
def test_grid_limit_follows_the_tiles(dtype, rows):
    """The f32 kernels' grid runs over 16-row tiles in its y dimension, so
    an f32 sequence meets the 65535 limit at 16 x 65535 rows. Every bf16
    kernel has a 1-d grid, so a bf16 sequence past 64 x 65535 rows is not
    refused for the grid."""
    ok = torch.empty((1, rows * 65535, 1, 128), dtype=dtype, device="meta")
    flash._check_kernel_inputs(ok, ok, ok)
    longer = torch.empty((1, rows * 65535 + 1, 1, 128), dtype=dtype, device="meta")
    if dtype == BF16:
        flash._check_kernel_inputs(longer, longer, longer)
        assert flash.dq_layout(longer, longer, longer, longer, DQ_TILES).blocks == 32768
    else:
        assert flash._F32_TILE_ROWS == rows
        with pytest.raises(ValueError, match="grid"):
            flash._check_kernel_inputs(longer, longer, longer)


def test_broadcast_operands_are_refused_or_copied():
    """A stride-0 dim of size > 1 cannot be read by TMA: q, k or v so laid
    out is refused before any launch, and the wrapper copies such a dO (the
    gradient of o.sum(1) or o.mean(1)) rather than raise."""
    q = torch.empty((2, 64, 4, 128), dtype=BF16)
    wide = torch.empty((2, 64, 1, 128), dtype=BF16).expand(2, 64, 4, 128)
    assert flash._kernel_readable(q) and not flash._kernel_readable(wide)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        flash._check_kernel_inputs(q, wide, wide)
    # f32 kernels read by their strides, a broadcast dim included.
    assert flash._kernel_readable(wide.float())
