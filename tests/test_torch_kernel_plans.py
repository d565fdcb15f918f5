"""The host-side plans of the port's CUDA kernels, on the CPU.

The kernels run only on the card, but what their wrappers decide before a
launch is plain Python: B2's split of the block table into chunks and the
size of its merge workspace, B5's tensor-core tiles and split of K, the
workspaces the wrappers keep between calls, and the scales handed to the
epilogues. A row's bits must not depend on the call's row count or on the
lanes' positions (the verify contract), so these plans may follow only from
the shapes that fix a row's arithmetic; the tests hold them to that.
"""
import inspect
import math

import pytest
import torch

from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scratch

# (T, ps, hd): glm4-9b's serving table (max_len 512, pages of 16, hd 128),
# a long context, the smoke model's head width, the card tests' small pages.
B2_SHAPES = [(32, 16, 128), (512, 16, 128), (4, 16, 16), (8, 8, 32), (16, 64, 256), (3, 4, 128)]


@pytest.mark.parametrize("t,ps,hd", B2_SHAPES)
def test_b2_chunk_plan_follows_from_table_page_and_head_widths(t, ps, hd):
    """Pages a chunk come from (ps, hd) alone (about 64 KB of f32 K and V
    rows, at most 128 positions, at least one page); the chunk count from
    the table width; neither takes Q or the positions."""
    assert list(inspect.signature(tpa.chunk_plan).parameters) == ["t", "ps", "hd"]
    pages, chunks = tpa.chunk_plan(t, ps, hd)
    assert pages >= 1 and chunks == math.ceil(t / pages)
    assert pages == tpa.chunk_plan(1, ps, hd)[0] == tpa.chunk_plan(10 * t, ps, hd)[0]
    if pages > 1:
        assert pages * ps <= 128 and 8 * pages * ps * hd <= 64 << 10


def test_b2_chunk_plan_at_glm4_9b():
    """glm4-9b (hd 128, pages of 16, max_len 512): chunks of 4 pages (64
    positions), 8 of them, so a decode step of 8 lanes and 2 KV heads runs
    16 x 8 attention blocks."""
    assert tpa.chunk_plan(512 // 16, 16, 128) == (4, 8)


@pytest.mark.parametrize("t,ps,hd", B2_SHAPES)
def test_b2_merge_workspace_per_row_follows_from_t_ps_hd(t, ps, hd):
    """The merge workspace holds every chunk's f32 accumulator and (max,
    sum) for each output row: the bytes a row follow from (T, ps, hd); a
    call of Q tokens needs B*Q*H rows of them, whatever the positions."""
    assert list(inspect.signature(tpa.merge_bytes_per_row).parameters) == ["t", "ps", "hd"]
    per_row = tpa.merge_bytes_per_row(t, ps, hd)
    assert per_row == 4 * tpa.chunk_plan(t, ps, hd)[1] * (hd + 2)


def test_b2_merge_workspace_at_glm4_9b():
    """8 lanes x 32 heads: about 1 MB at Q = 1 and 18 MB at Q = 17."""
    per_row = tpa.merge_bytes_per_row(32, 16, 128)
    assert 8 * 1 * 32 * per_row == 1_064_960
    assert 8 * 17 * 32 * per_row == 18_104_320


@pytest.mark.parametrize("qn,rep,hd,ps", [(1, 16, 128, 16), (17, 16, 128, 16), (5, 2, 128, 8),
                                          (3, 4, 16, 16), (2, 32, 256, 64), (9, 1, 64, 4)])
def test_b2_tile_fits_shared_memory(qn, rep, hd, ps):
    """The tile's query rows, the chunk's K/V tiles, the scores and an int8
    pool's staged bytes fit one block's shared memory."""
    rows = tpa.tile_rows(qn, rep, hd, ps)
    assert rows % rep == 0
    assert tpa._smem_bytes(rows, hd, ps) <= tpa._MAX_SMEM


# glm4-9b's clip-only linear shapes (K, N) and B5's tensor-core split plan.
TC_PLANS = {
    "wq/wo": ((4096, 4096), (480, 9)),
    "wk/wv": ((4096, 256), (256, 16)),
    "w_gate/w_up": ((4096, 13696), (1376, 3)),
    "w_down": ((13696, 4096), (1536, 9)),
    "lm_head": ((4096, 151552), (4096, 1)),
}


@pytest.mark.parametrize("name", list(TC_PLANS))
def test_b5_tc_split_plan_follows_from_k_and_n(name):
    """B5's split of K over the grid takes (K, N) only: 32-row stages, the
    splits cover K, and each split but the last is a whole number of
    stages."""
    (k, n), want = TC_PLANS[name]
    assert list(inspect.signature(tqm.tc_split_plan).parameters) == ["k", "n"]
    k_chunk, nsplit = tqm.tc_split_plan(k, n)
    assert (k_chunk, nsplit) == want
    assert k_chunk % 32 == 0 and (nsplit - 1) * k_chunk < k <= nsplit * k_chunk


@pytest.mark.parametrize("k,n", [(1000, 200), (130, 336), (32, 4), (300, 52)])
def test_b5_tc_split_plan_ragged(k, n):
    k_chunk, nsplit = tqm.tc_split_plan(k, n)
    assert k_chunk % 32 == 0 and nsplit >= 1
    assert (nsplit - 1) * k_chunk < k <= nsplit * k_chunk


@pytest.mark.parametrize("name", list(TC_PLANS))
def test_b5_row_chunks_bound_the_workspace(name):
    """With a split K the partials go through a workspace [splits, rows, N];
    a long prefill runs in row chunks that keep it within 64 MiB; one split
    needs no workspace and runs in one launch."""
    (k, n), _ = TC_PLANS[name]
    nsplit = tqm.tc_split_plan(k, n)[1]
    for m in (1, 8, 40, 136, 512, 8192):
        rows = tqm.wo_row_chunk(m, n, nsplit)
        assert 1 <= rows <= m and 4 * nsplit * rows * n <= tqm._MAX_PART_BYTES
        if m <= 136 and nsplit > 1:
            assert rows == m, (name, m)


@pytest.mark.parametrize("name", list(TC_PLANS))
@pytest.mark.parametrize("m", [1, 8, 40, 256, 8192])
def test_b5_launch_plan(name, m):
    """A call's launch plan: the (K, N) split, row chunks and workspace
    only with a split, counters for every token tile and column tile of a
    chunk; a smaller workspace bound takes effect at once (it is part of
    the cached plan's key)."""
    (k, n), (k_chunk, nsplit) = TC_PLANS[name]
    plan = tqm._tc_launch_plan(m, k, n, tqm._MAX_PART_BYTES)
    assert plan[:2] == (k_chunk, nsplit)
    rows, part_bytes, count_bytes = plan[2:]
    if nsplit == 1:
        assert (rows, part_bytes, count_bytes) == (m, 0, 0)
    else:
        assert rows == tqm.wo_row_chunk(m, n, nsplit) and part_bytes == 4 * nsplit * rows * n
        assert part_bytes <= tqm._MAX_PART_BYTES
        # one counter per token tile (8 tokens or more) and 128-column tile
        assert count_bytes == 4 * math.ceil(rows / 8) * math.ceil(n / 128)
        small = tqm._tc_launch_plan(m, k, n, 4 * nsplit * 12 * n)
        assert small[2] == min(m, 12)


def test_scratch_reused_for_equal_sizes_renewed_for_larger():
    """A kept buffer serves every request up to its size and is replaced by
    a larger one when asked for more; keys and devices keep apart."""
    scratch.clear()
    a = scratch.buffer("plans-test", "cpu", 1000)
    assert a.dtype == torch.uint8 and a.numel() == 1000
    assert scratch.buffer("plans-test", "cpu", 1000) is a
    assert scratch.buffer("plans-test", "cpu", 10) is a
    b = scratch.buffer("plans-test", "cpu", 4000)
    assert b is not a and b.numel() == 4000
    assert scratch.buffer("plans-test", "cpu", 2000) is b
    other = scratch.buffer("plans-test-2", "cpu", 10)
    assert other is not b
    z = scratch.buffer("plans-test-zeroed", "cpu", 64, zeroed=True)
    assert int(z.sum()) == 0
    scratch.clear()
    assert scratch.buffer("plans-test", "cpu", 10) is not b


def test_split_k_workspace_view_is_kept():
    """The split-K workspace the weight-only wrappers hand the kernels is a
    float32 view of the kept buffer: equal sizes reuse it."""
    scratch.clear()
    p1 = tqm._part(torch.device("cpu"), 3, 8, 256)
    p2 = tqm._part(torch.device("cpu"), 3, 8, 256)
    assert p1.dtype == torch.float32 and p1.numel() == 3 * 8 * 256
    assert p1.data_ptr() == p2.data_ptr()
    assert tqm._part(torch.device("cpu"), 3, 4, 256).data_ptr() == p1.data_ptr()
    assert tqm._part(torch.device("cpu"), 9, 8, 256).numel() == 9 * 8 * 256
    scratch.clear()


def test_scales_without_x_scale_makes_no_ones_tensor(monkeypatch):
    """``scales(x_scale=None)`` hands the epilogue None (read as 1) and
    allocates no ones tensor; a scalar or [M] x_scale comes back [M]."""
    x = torch.zeros((5, 8), dtype=torch.bfloat16)

    def no_ones(*a, **k):
        raise AssertionError("scales made a ones tensor")

    monkeypatch.setattr(torch, "ones", no_ones)
    xs, ws = tqm.scales(x, torch.full((6,), 0.5), None, 6)
    assert xs is None and ws.shape == (6,) and ws.dtype == torch.float32
    xs, ws = tqm.scales(x, 0.25, 2.0, 6)
    assert xs.shape == (5,) and ws.shape == (6,) and bool((xs == 2.0).all())
    with pytest.raises(ValueError, match="x_scale"):
        tqm.scales(x, 0.25, torch.zeros(3), 6)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32, torch.int8])
def test_plain_epilogue_without_x_scale_is_bitwise_ones(dt):
    """The plain versions read a null x_scale as 1: ``acc * w_scale`` is
    bit for bit ``acc * (1 * w_scale)``, the old all-ones x_scale."""
    g = torch.Generator().manual_seed(7)
    if dt == torch.int8:
        x = torch.randint(-127, 128, (6, 40), generator=g, dtype=torch.int8)
    else:
        x = (torch.randn((6, 40), generator=g) * 3).to(dt)
    w8 = torch.randint(-127, 128, (40, 12), generator=g, dtype=torch.int8)
    ws = torch.rand((12,), generator=g) * 0.01 + 1e-4
    got = tqm.quant_matmul_plain(x, w8, ws, out_dtype=torch.float32)
    want = tref.quant_matmul_ref(x, w8, torch.full((6,), 1.0), ws, torch.float32)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("hd,ps,ok", [(128, 16, True), (16, 4, True), (128, 2, False),
                                      (128, 1, False), (40, 16, False)])
def test_b2_check_layout(hd, ps, ok):
    """B2's kernel copies page rows in 16-byte pieces: the wrapper and a
    card engine refuse a head width not a multiple of 16 or pages of fewer
    than 4 rows (or not a multiple of 4), with the reason."""
    if ok:
        tpa.check_layout(hd, ps)
    else:
        with pytest.raises(ValueError, match="head width % 16 and page size % 4"):
            tpa.check_layout(hd, ps)


def test_cpu_engine_serves_short_pages():
    """Only a card engine refuses short pages: the plain path takes any
    power of two."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServingEngine

    cfg = smoke_config("glm4-9b")
    eng = ServingEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                        EngineConfig(max_batch=2, max_len=32, page_size=2), device="cpu")
    assert eng.page_size == 2
