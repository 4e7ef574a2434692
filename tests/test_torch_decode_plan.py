"""The split plan of the split-K core (ops/decode_matmul.split_plan), whose
split count the CUDA kernel takes for K4-K7 and matmul_q8 (it cuts
the chunks at the same bounds): the chunk ranges cover the reduction depth
exactly once (int8 rows, or folded int4 byte rows), the blocks fill the
H100's 132 SMs, uneven splits where the chunks do not divide, one split at
the LM heads' widths, at most a cluster's 8 splits, and the widths the
tiling cannot take refused. Plain Python: runs on the CPU."""

import pytest

from videollama2_tpu_torch.ops import decode_matmul as dm

# (D, F) of Mistral-7B, Qwen2-7B and Llama-2-7B
WIDTHS = [(4096, 14336), (3584, 18944), (4096, 11008)]


def _passes(D, F):
    """(din, dout) of an FFN's two passes: gate/up, then down."""
    return ((D, F), (F, D))


@pytest.mark.parametrize("rows", [1, 16, 64])
@pytest.mark.parametrize("D,F", WIDTHS)
def test_chunks_cover_the_depth_once(rows, D, F):
    for din, dout in _passes(D, F):
        plan = dm.split_plan(rows, din, dout)
        chunks = din // dm.SPLIT_CHUNK
        assert plan.bounds[0] == 0 and plan.bounds[-1] == chunks
        assert len(plan.bounds) == plan.splits + 1
        sizes = [b - a for a, b in zip(plan.bounds, plan.bounds[1:])]
        assert all(n >= 1 for n in sizes) and sum(sizes) == chunks
        covered = [c for a, b in zip(plan.bounds, plan.bounds[1:])
                   for c in range(a, b)]
        assert covered == list(range(chunks))
        assert plan.tiles * dm.SPLIT_TILE == dout
        assert plan.splits <= dm.SPLIT_MAX
        assert plan.chunk_rows == dm.SPLIT_CHUNK


@pytest.mark.parametrize("D,F", WIDTHS)
def test_blocks_fill_the_sms(D, F):
    """Every pass puts at least one block on each of the 132 SMs, split K
    to do so, and lands within half a split of SPLIT_BLOCKS_PER_SM blocks
    an SM, or below it at SPLIT_MAX splits (a cluster's portable size)."""
    for din, dout in _passes(D, F):
        plan = dm.split_plan(16, din, dout)
        blocks = plan.tiles * plan.splits
        assert blocks >= dm.H100_SMS and plan.splits > 1, (din, dout, plan)
        target = dm.SPLIT_BLOCKS_PER_SM * dm.H100_SMS
        assert abs(blocks - target) <= plan.tiles / 2 or (
            plan.splits == dm.SPLIT_MAX and blocks < target), (din, dout,
                                                               plan)


def test_uneven_splits_at_qwen2_width():
    """F 18944 is 74 chunks: the down pass's splits differ by one chunk."""
    plan = dm.split_plan(16, 18944, 3584)
    sizes = {b - a for a, b in zip(plan.bounds, plan.bounds[1:])}
    assert 74 % plan.splits != 0 and sizes == {74 // plan.splits,
                                               74 // plan.splits + 1}


def test_plans_at_the_main_path_widths():
    """K5's plans on the H100 at R 16 (PERF.md's K5 rows)."""
    got = {(din, dout): dm.split_plan(16, din, dout)[:2]
           for D, F in WIDTHS[:2] for din, dout in _passes(D, F)}
    assert got == {(4096, 14336): (112, 2), (14336, 4096): (32, 8),
                   (3584, 18944): (148, 2), (18944, 3584): (28, 8)}


def test_few_chunks_cap_the_splits():
    """A depth of one chunk takes one split whatever the width, and a
    narrow output no more than SPLIT_MAX, a cluster's portable size."""
    plan = dm.split_plan(16, 256, 128)
    assert plan.splits == 1 and plan.bounds == (0, 1)
    assert dm.split_plan(16, 4096, 512).splits == dm.SPLIT_MAX


@pytest.mark.parametrize("rows,din,dout", [
    (16, 4096, 14400),   # Dout not a multiple of the 128-column tile
    (16, 4000, 14336),   # Din not a multiple of the 256-row chunk
    (16, 3584, 4640),
    (0, 4096, 14336),    # no rows
    (65, 4096, 14336),   # more than four 16-row tiles
])
def test_untiled_widths_are_refused(rows, din, dout):
    with pytest.raises(ValueError):
        dm.split_plan(rows, din, dout)


@pytest.mark.parametrize("rows", [1, 16, 64])
@pytest.mark.parametrize("D,F", WIDTHS)
def test_folded_chunks_cover_the_byte_rows_once(rows, D, F):
    """K7's passes over folded int4 packs: a chunk is 128 byte rows (256
    weight rows), and the splits' byte-row ranges cover the pack's Din/2
    byte rows exactly once; Llama's down pass (F 11008: 5504 byte rows) is
    43 chunks."""
    for din, dout in _passes(D, F):
        plan = dm.split_plan(rows, din, dout, folded=True)
        assert plan.chunk_rows == dm.SPLIT_CHUNK // 2
        assert plan == dm.split_plan(rows, din, dout)._replace(
            chunk_rows=plan.chunk_rows)
        byte_rows = [r for a, b in zip(plan.bounds, plan.bounds[1:])
                     for r in range(a * plan.chunk_rows, b * plan.chunk_rows)]
        assert byte_rows == list(range(din // 2))
    if F == 11008:
        assert dm.split_plan(rows, F, D, folded=True).bounds[-1] == 43


# K4's plans at R 16: (Din, Dout) -> (tiles, splits), the fused qkv and
# the o projection of each model
K4_PLANS = {
    "mistral qkv": ((4096, 6144), (48, 6)),
    "mistral o": ((4096, 4096), (32, 8)),
    "qwen2 qkv": ((3584, 4608), (36, 7)),
    "qwen2 o": ((3584, 3584), (28, 8)),
    "llama qkv": ((4096, 12288), (96, 3)),
    "llama o": ((4096, 4096), (32, 8)),
}


@pytest.mark.parametrize("name", sorted(K4_PLANS))
def test_k4_plans_at_the_projection_widths(name):
    """K4 runs the core's one-weight pass: its plans at the six projection
    widths split every tile so the blocks fill the SMs, each split at least
    one chunk."""
    (din, dout), want = K4_PLANS[name]
    plan = dm.split_plan(16, din, dout)
    assert (plan.tiles, plan.splits) == want
    assert plan.tiles * plan.splits >= dm.H100_SMS


@pytest.mark.parametrize("rows", [16, 64])
@pytest.mark.parametrize("din,dout", [(4096, 32000), (3584, 152064)])
def test_lm_heads_take_one_split(rows, din, dout):
    """matmul_q8 at the Mistral and Qwen2 LM heads' widths (250 and 1188
    column tiles): one split, whose blocks write the output from their
    registers."""
    plan = dm.split_plan(rows, din, dout)
    assert plan.splits == 1 and plan.bounds == (0, din // dm.SPLIT_CHUNK)


# K6's folded plans at R 16: (Din, Dout) -> (tiles, splits), the fused qkv
# and the o projection of Mistral-7B and Qwen2-7B (chunks of 128 byte rows,
# 256 weight rows: the same counts as K4's)
K6_PLANS = {
    "mistral qkv": ((4096, 6144), (48, 6)),
    "mistral o": ((4096, 4096), (32, 8)),
    "qwen2 qkv": ((3584, 4608), (36, 7)),
    "qwen2 o": ((3584, 3584), (28, 8)),
}


@pytest.mark.parametrize("name", sorted(K6_PLANS))
def test_k6_folded_plans_at_the_projection_widths(name):
    """K6 runs the core's one-weight pass over the folded int4 pack: its
    plans at the qkv and o widths of both models split every tile so the
    blocks fill the SMs, at most SPLIT_MAX splits, and the splits' byte-row
    ranges cover the pack's Din/2 byte rows exactly once."""
    (din, dout), want = K6_PLANS[name]
    plan = dm.split_plan(16, din, dout, folded=True)
    assert (plan.tiles, plan.splits) == want
    assert plan.tiles * plan.splits >= dm.H100_SMS
    assert 1 < plan.splits <= dm.SPLIT_MAX
    assert plan.chunk_rows == dm.SPLIT_CHUNK // 2
    byte_rows = [r for a, b in zip(plan.bounds, plan.bounds[1:])
                 for r in range(a * plan.chunk_rows, b * plan.chunk_rows)]
    assert byte_rows == list(range(din // 2))
