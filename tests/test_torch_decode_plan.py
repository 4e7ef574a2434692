"""K5's split plan (ops/decode_matmul.ffn_split_plan), which the CUDA
kernel takes as it is: the chunk ranges cover the reduction depth exactly
once, the blocks fill the H100's 132 SMs, uneven splits where the chunks
do not divide, and the widths the tiling cannot take refused. Plain
Python: runs on the CPU."""

import pytest

from videollama2_tpu_torch.ops import decode_matmul as dm

# (D, F) of Mistral-7B, Qwen2-7B and Llama-2-7B
WIDTHS = [(4096, 14336), (3584, 18944), (4096, 11008)]


def _passes(D, F):
    """(din, dout, weights) of K5's two passes: gate/up, then down."""
    return ((D, F, 2), (F, D, 1))


@pytest.mark.parametrize("rows", [1, 16, 64])
@pytest.mark.parametrize("D,F", WIDTHS)
def test_chunks_cover_the_depth_once(rows, D, F):
    for din, dout, weights in _passes(D, F):
        plan = dm.ffn_split_plan(rows, din, dout, weights)
        chunks = din // dm.SPLIT_CHUNK
        assert plan.bounds[0] == 0 and plan.bounds[-1] == chunks
        assert len(plan.bounds) == plan.splits + 1
        sizes = [b - a for a, b in zip(plan.bounds, plan.bounds[1:])]
        assert all(n >= 1 for n in sizes) and sum(sizes) == chunks
        covered = [c for a, b in zip(plan.bounds, plan.bounds[1:])
                   for c in range(a, b)]
        assert covered == list(range(chunks))
        assert plan.tiles * dm.SPLIT_TILE == dout
        assert plan.workspace == (plan.tiles * plan.splits * weights * rows
                                  * dm.SPLIT_TILE)


@pytest.mark.parametrize("D,F", WIDTHS)
def test_blocks_fill_the_sms(D, F):
    """Every pass puts at least one block on each of the 132 SMs, split K
    to do so, and lands within half a split of SPLIT_BLOCKS_PER_SM blocks
    an SM."""
    for din, dout, weights in _passes(D, F):
        plan = dm.ffn_split_plan(16, din, dout, weights)
        blocks = plan.tiles * plan.splits
        assert blocks >= dm.H100_SMS and plan.splits > 1, (din, dout, plan)
        assert abs(blocks - dm.SPLIT_BLOCKS_PER_SM * dm.H100_SMS) \
            <= plan.tiles / 2, (din, dout, plan)


def test_uneven_splits_at_qwen2_width():
    """F 18944 is 74 chunks: the down pass's splits differ by one chunk."""
    plan = dm.ffn_split_plan(16, 18944, 3584, 1)
    sizes = {b - a for a, b in zip(plan.bounds, plan.bounds[1:])}
    assert 74 % plan.splits != 0 and sizes == {74 // plan.splits,
                                               74 // plan.splits + 1}


def test_plans_at_the_main_path_widths():
    """The plans the H100 runs at R 16 (PERF.md's K5 rows)."""
    got = {(din, dout, w): dm.ffn_split_plan(16, din, dout, w)[:2]
           for D, F in WIDTHS[:2] for din, dout, w in _passes(D, F)}
    assert got == {(4096, 14336, 2): (112, 2), (14336, 4096, 1): (32, 8),
                   (3584, 18944, 2): (148, 2), (18944, 3584, 1): (28, 9)}


def test_few_chunks_cap_the_splits():
    """A depth of one chunk takes one split whatever the width."""
    plan = dm.ffn_split_plan(16, 256, 128, 1)
    assert plan.splits == 1 and plan.bounds == (0, 1)


@pytest.mark.parametrize("rows,din,dout", [
    (16, 4096, 14400),   # Dout not a multiple of the 128-column tile
    (16, 4000, 14336),   # Din not a multiple of the 256-row chunk
    (16, 3584, 4640),
    (0, 4096, 14336),    # no rows
    (65, 4096, 14336),   # more than four 16-row tiles
])
def test_untiled_widths_are_refused(rows, din, dout):
    with pytest.raises(ValueError):
        dm.ffn_split_plan(rows, din, dout, 2)
