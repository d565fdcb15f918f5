"""The host-side plans of the port's CUDA kernels, on the CPU.

The kernels run only on the card, but what their wrappers decide before a
launch is plain Python: B2's split of the block table into chunks and the
size of its merge workspace, the tensor-core tiles and split of K that B5
and B4 share (B4's over the virtual rows of its OCS tail), B1's int8
tensor-core tile and split (free to follow M: its sums are integers), B6's
on the same GEMM over its int4 and outlier stages, the columns a ragged N
runs, the workspaces
the wrappers keep between calls, and the scales handed to the epilogues. A
row's bits must not depend on the call's row count or on the lanes'
positions (the verify contract), so these plans may follow only from the
shapes that fix a row's arithmetic; the tests hold them to that. B4's
weight-only route (tensor cores or CUDA cores) and what ``dense`` declares
to it are host decisions too.
"""
import inspect
import math
from collections import Counter

import pytest
import torch

from repro_torch.kernels import fused_qmatmul as tfq
from repro_torch.kernels import ocs_matmul as tom
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scratch
from repro_torch.kernels import w4a8_qmatmul as tw4

# (T, ps, hd): glm4-9b's serving table (max_len 512, pages of 16, hd 128),
# a long context, the smoke model's head width, the card tests' small pages,
# and pages of 1 and 2 rows (the smoke model's too, and a head width whose
# chunk is not a power of two).
B2_SHAPES = [(32, 16, 128), (512, 16, 128), (4, 16, 16), (8, 8, 32), (16, 64, 256), (3, 4, 128),
             (512, 1, 128), (256, 2, 128), (64, 1, 16), (40, 2, 176)]


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


@pytest.mark.parametrize("ps,hd,want", [(1, 128, (64, 8)), (2, 128, (32, 8)), (4, 128, (16, 8)),
                                        (1, 16, (128, 4)), (2, 16, (64, 4))])
def test_b2_chunk_plan_at_short_pages(ps, hd, want):
    """Pages of 1 and 2 rows, at glm4-9b's and the smoke model's head
    widths over a 512-position table: the chunk keeps its positions (64 at
    hd 128), so the chunk count does not grow as the pages shrink."""
    assert tpa.chunk_plan(512 // ps, ps, hd) == want


@pytest.mark.parametrize("ps", [1, 2, 4, 8, 16, 64])
@pytest.mark.parametrize("hd", [16, 48, 128, 176, 256])
def test_b2_chunk_is_whole_pages_and_a_multiple_of_4_positions(ps, hd):
    """The kernel reads each row of chunk scores 4 positions at a time and
    copies whole pages: a chunk holds at least one whole page and a multiple
    of 4 positions at every page size, pages of 1 and 2 rows too."""
    pages, _ = tpa.chunk_plan(1, ps, hd)
    assert pages >= 1 and pages * ps % 4 == 0
    assert pages * ps <= max(128, ps)


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


# glm4-9b's OCS linear shapes (K, S, N) and B4's tensor-core split plan over
# its Kb + S virtual rows: S as the serving launcher's recipe leaves it (r =
# 0.02, ``pad_to=1``: 82, 274 at w_down) and after ``pad_to=128`` (128, 384).
B4_TC_PLANS = {
    "wq/wo": ((4096, 82, 4096), (480, 9)),
    "wk/wv": ((4096, 82, 256), (288, 15)),
    "w_gate/w_up": ((4096, 82, 13696), (1408, 3)),
    "w_down": ((13696, 274, 4096), (1568, 9)),
    "lm_head": ((4096, 82, 151552), (4192, 1)),
    "wq/wo pad_to=128": ((4096, 128, 4096), (480, 9)),
    "wk/wv pad_to=128": ((4096, 128, 256), (288, 15)),
    "w_gate/w_up pad_to=128": ((4096, 128, 13696), (1408, 3)),
    "w_down pad_to=128": ((13696, 384, 4096), (1568, 9)),
    "lm_head pad_to=128": ((4096, 128, 151552), (4224, 1)),
}


@pytest.mark.parametrize("name", list(B4_TC_PLANS))
def test_b4_tc_split_plan_at_glm4_9b(name):
    """B4's split on the tensor cores is B5's plan over Kb + S virtual rows
    (Kb = K rounded up to a 32-row stage): a function of (K, S, N) alone,
    whole stages a split, the splits covering the virtual rows."""
    (k, s, n), want = B4_TC_PLANS[name]
    kv = tqm.tc_rows(k, s)
    assert kv == k + (-k) % 32 + s
    k_chunk, nsplit = tqm.tc_split_plan(kv, n)
    assert (k_chunk, nsplit) == want
    assert k_chunk % 32 == 0 and (nsplit - 1) * k_chunk < kv <= nsplit * k_chunk


@pytest.mark.parametrize("name", list(B4_TC_PLANS))
def test_b4_tc_launch_plan_independent_of_m(name):
    """The split of a B4 call does not depend on its row count, so a row's
    bits are the same in a decode step, a verify and a prefill; only the
    row chunks (which bound the workspace) do."""
    (k, s, n), want = B4_TC_PLANS[name]
    for m in (1, 3, 8, 13, 40, 256, 8192):
        plan = tqm._tc_launch_plan(m, tqm.tc_rows(k, s), n, tqm._MAX_PART_BYTES)
        assert plan[:2] == want
        if want[1] > 1:
            assert plan[2] == tqm.wo_row_chunk(m, n, want[1])
            assert plan[3] <= tqm._MAX_PART_BYTES


def _tc_walk(k, s, n):
    """The tensor-core kernel's walk over its contraction
    (``csrc/wo_tc_gemm.cuh``) under the wrapper's plan: every split's
    32-row stages; a base stage (virtual rows r < Kb) pairs weight row r
    with token column r (the TMA's zeros past K), a tail stage weight row
    K + (r - Kb) with tail entry r - Kb (zeros at or past S, or past the
    split). Returns the live reads: token columns, tail entries and weight
    rows, each with its count."""
    kv = tqm.tc_rows(k, s)
    kb = kv - s
    k_chunk, nsplit = tqm.tc_split_plan(kv, n)
    cols, tail, wrows = Counter(), Counter(), Counter()
    for z in range(nsplit):
        kz0, kz1 = z * k_chunk, min(kv, (z + 1) * k_chunk)
        assert kz0 < kz1 and kz0 % 32 == 0
        for k0 in range(kz0, kz1, 32):
            is_tail = s > 0 and k0 >= kb
            assert is_tail or k0 + 32 <= kb or s == 0  # no stage mixes base and tail rows
            for r in range(k0, min(k0 + 32, kz1)):
                if is_tail:
                    if r - kb < s:
                        tail[r - kb] += 1
                        wrows[k + r - kb] += 1
                elif r < k:
                    cols[r] += 1
                    wrows[r] += 1
    return cols, tail, wrows


@pytest.mark.parametrize("k,s,n", [(4096, 82, 4096), (13696, 274, 4096), (1000, 70, 208),
                                   (4104, 130, 400), (1000, 70, 200), (130, 7, 336),
                                   (32, 1, 4), (33, 31, 16), (300, 32, 52), (4096, 0, 256),
                                   (1000, 0, 208)])
def test_b4_tc_virtual_rows_cover_each_row_once(k, s, n):
    """For ragged K and S the virtual rows map onto the weights without a
    gap or a repeat: every token column and tail entry is read once, every
    weight row once with a live operand (K + (r - Kb) for tail rows), and
    the splits cover the virtual rows in whole stages."""
    cols, tail, wrows = _tc_walk(k, s, n)
    assert cols == Counter(range(k))
    assert tail == Counter(range(s))
    assert wrows == Counter(range(k + s))


def test_b4_launch_tc_takes_the_plan_of_its_virtual_rows(monkeypatch):
    """``launch_tc`` hands B4's entry point the split of Kb + S rows and its
    tail arguments between K and the scales, in row chunks of the workspace
    bound (a stand-in entry point records the calls; nothing launches)."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("Stream", (), {"cuda_stream": 7}))
    monkeypatch.setattr(tqm, "_MAX_PART_BYTES", 4 * 15 * 12 * 256)
    calls = []
    x = torch.zeros((40, 4096), dtype=torch.bfloat16)
    out = torch.empty((40, 256), dtype=torch.bfloat16)
    ws = torch.ones(256)
    err = tqm.launch_tc(lambda *a: calls.append(a) or 0, x, out, None, ws,
                        tqm.tc_rows(4096, 82), 82, 111, 222, 333)
    assert err == 0
    assert [c[2] for c in calls] == [12, 12, 12, 4]  # rows a launch
    for c in calls:
        assert c[1] == 1  # one expert: a 2-D call
        assert c[3:8] == (4096, 82, 111, 222, 333)  # K, S, src_tail, tail_mult, w8
        assert c[8] is None and c[9] == ws.data_ptr()
        assert c[10:13] == (256, 288, 15)  # N, k_chunk, nsplit
        assert c[-2:] == (1, 7)  # bf16 out, the stream
    scratch.clear()


@pytest.mark.parametrize("dt,mult,declared,want", [
    (torch.bfloat16, None, False, True),
    (torch.bfloat16, None, True, True),
    (torch.bfloat16, [1.0, 0.0, 1.0], False, False),
    (torch.bfloat16, [1.0, 1.0, 1.0], False, False),
    (torch.bfloat16, [1.0, 0.5, 0.0], False, False),
    (torch.bfloat16, [1.0, 1.0, 0.0], True, True),
    (torch.float32, None, False, False),
    (torch.float32, [1.0, 0.0, 1.0], True, False),
])
def test_b4_route_takes_tensor_cores_for_bf16_and_a_mask(dt, mult, declared, want):
    """Only bf16 x whose tail multipliers are absent or declared a 0/1 mask
    takes the tensor cores: every product is then exact in bf16. The route
    reads no multiplier (a read would wait on the device at every call), so
    an undeclared mask, like any other multiplier or f32 x, stays on the
    CUDA cores."""
    x = torch.zeros((2, 8), dtype=dt)
    m = None if mult is None else torch.tensor(mult)
    assert tom.tc_route(x, m, declared) is want


@pytest.mark.parametrize("mult,bias,packed", [([1.0, 1.0, 0.0], 0.0, True),
                                              ([1.0, 0.5, 1.0], 0.0, False),
                                              ([1.0, 1.0, 1.0], 0.25, False)])
def test_ocs_dequant_declares_the_mask_of_a_packed_leaf(monkeypatch, mult, bias, packed):
    """``dense`` in dequant passes ``tail_is_mask=w.is_packed()``: a packed
    leaf's multipliers are declared a 0/1 mask (the tensor-core route on the
    card, with no read-back per call), another leaf's are not (the CUDA-core
    route)."""
    from repro_torch.core.ocs import OCSQuantLinear, OCSSpec
    from repro_torch.core.quantizer import QuantParams
    from repro_torch.models import layers

    seen = []

    def fake(x, w8, ws, src, x_scale=None, tail_mult=None, *, tail_is_mask=False,
             out_dtype=None):
        seen.append(tail_is_mask)
        return torch.zeros((x.shape[0], w8.shape[1]), dtype=out_dtype)

    monkeypatch.setattr(layers.kops, "ocs_quant_matmul", fake)
    w = OCSQuantLinear(
        weight=QuantParams(values=torch.zeros((7, 6), dtype=torch.int8),
                           scale=torch.ones((1, 6)), bits=8, channel_axis=1),
        spec=OCSSpec(src=torch.tensor([0, 1, 2, 3, 0, 1, 2], dtype=torch.int32),
                     mult=torch.tensor([1.0] * 4 + mult),
                     bias=torch.tensor([0.0] * 4 + [bias, 0.0, 0.0])),
        n_orig=4)
    y = layers.dense(w, torch.zeros((3, 4), dtype=torch.bfloat16), mode="dequant")
    assert y.shape == (3, 6) and seen == [packed]


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


@pytest.mark.parametrize("hd,ps,ok", [(128, 16, True), (16, 4, True), (128, 2, True),
                                      (128, 1, True), (16, 1, True), (40, 16, False),
                                      (40, 2, False)])
def test_b2_check_layout(hd, ps, ok):
    """B2's kernel copies page rows in 8- and 16-byte pieces and a short
    page's scales one at a time: the wrapper and a card engine take any
    page size the engine does (pages of 1 and 2 rows too) and refuse a head
    width not a multiple of 16, with the reason."""
    if ok:
        tpa.check_layout(hd, ps)
    else:
        with pytest.raises(ValueError, match="head width % 16 must be 0"):
            tpa.check_layout(hd, ps)


def test_cpu_engine_serves_short_pages():
    """The plain path takes any power of two; so does a card engine now
    (``tests/test_torch_cuda.py`` serves pages of 2 rows there)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServingEngine

    cfg = smoke_config("glm4-9b")
    eng = ServingEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                        EngineConfig(max_batch=2, max_len=32, page_size=2), device="cpu")
    assert eng.page_size == 2


# glm4-9b's W8A8 linear shapes (K, S, N), S as the serving recipe leaves it,
# and hymba-1.5b's lm_head (K 1600, no tail) as B1's wrapper runs it (N
# 32001 zero-padded to 32016): B1's launch plan on the int8 tensor cores at
# a decode step (M = 8) and a prefill (M = 256), as (tile, stages a split,
# splits, accumulator bytes, counter bytes).
B1_PLANS = {
    "wq/wo": ((4096, 82, 4096), (0, 15, 9, 131072, 64), (1, 44, 3, 4194304, 512)),
    "wk/wv": ((4096, 82, 256), (0, 5, 27, 8192, 4), (1, 5, 27, 262144, 32)),
    "w_gate/w_up": ((4096, 82, 13696), (0, 44, 3, 438272, 216), (1, 131, 1, 0, 0)),
    "w_down": ((13696, 274, 4096), (0, 49, 9, 131072, 64), (1, 146, 3, 4194304, 512)),
    "lm_head": ((4096, 82, 151552), (0, 131, 1, 0, 0), (1, 131, 1, 0, 0)),
    "hymba-1.5b lm_head": ((1600, 0, 32016), (0, 25, 2, 1024512, 504), (1, 50, 1, 0, 0)),
}
# Row counts: decode, the tile boundary, verifies (8 x 5, 8 x 17), prefill
# buckets and a long prefill.
B1_MS = (1, 8, 9, 16, 32, 40, 64, 136, 200, 256, 512, 8192)


def _kp(k, s):
    return k + s + (-(k + s)) % 16


@pytest.mark.parametrize("name", list(B1_PLANS))
def test_b1_launch_plan_at_glm4_9b(name):
    """B1's plan at a decode step and a prefill: the 8-token decode tile
    split to ~1 block an SM, the 64 x 128 tile to ~2; the lm_head and the
    prefill's w_gate/w_up fill the SMs with their tiles alone."""
    (k, s, n), decode, prefill = B1_PLANS[name]
    assert tfq.launch_plan(8, _kp(k, s), n) == decode
    assert tfq.launch_plan(256, _kp(k, s), n) == prefill


@pytest.mark.parametrize("m", B1_MS)
@pytest.mark.parametrize("name", list(B1_PLANS))
def test_b1_launch_plan_covers_the_contraction(name, m):
    """At every row count the tile follows M (8 tokens x 256 columns up to 8
    rows, then 64 x 128), the splits cover the contraction's 32-row stages
    with at least 4 stages a split, one split only where the tiles reach
    the blocks wanted (or the stages or the accumulator's bound stop it),
    and with a split the int32 accumulator [M, N] within its bound and one
    counter per token tile and column tile; one split needs neither."""
    (k, s, n), _, _ = B1_PLANS[name]
    kp = _kp(k, s)
    tile, per, nsplit, acc_bytes, count_bytes = tfq.launch_plan(m, kp, n)
    assert tile == tfq.tile_for(m) == (0 if m <= 8 else 1)
    toks, cols, want = tfq._TILES[tile]
    nst = math.ceil(kp / 32)
    assert (nsplit - 1) * per < nst <= nsplit * per
    assert nsplit <= max(1, nst // 4)
    tiles = math.ceil(m / toks) * math.ceil(n / cols)
    if nsplit == 1:
        assert (acc_bytes, count_bytes) == (0, 0)
        assert tiles >= want or nst < 8 or 4 * m * n > tfq._MAX_ACC_BYTES
    else:
        assert per >= 4
        assert acc_bytes == 4 * m * n <= tfq._MAX_ACC_BYTES
        assert count_bytes == 4 * tiles


def test_b1_tile_boundaries():
    """The decode tile of 8 tokens serves a decode step; the 64-token tile
    everything larger (verifies and prefills)."""
    assert [tfq.tile_for(m) for m in (1, 8, 9, 16, 32, 33, 40, 256)] == [0, 0, 1, 1, 1, 1, 1, 1]
    assert tfq._TILES == ((8, 256, 132), (64, 128, 264))


def test_b1_launch_hands_the_plan_and_kept_scratch_to_the_kernel(monkeypatch):
    """``launch`` hands B1's entry point the plan, the kept row scratch and,
    with a split, the kept accumulator and counters, both zeroed (a
    stand-in entry point records the calls; nothing launches); equal calls
    reuse the same buffers, and a call with one split passes neither."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("Stream", (), {"cuda_stream": 7}))
    scratch.clear()
    dev = torch.device("cpu")

    def calls_of(m, n, reps):
        x = torch.zeros((m, 4096), dtype=torch.bfloat16)
        w8 = torch.zeros((4096 + 82, n), dtype=torch.int8)
        ws, src = torch.ones(n), torch.zeros(82, dtype=torch.int32)
        out = torch.empty((m, n), dtype=torch.bfloat16)
        calls = []
        for _ in range(reps):
            assert tfq.launch(lambda *a: calls.append(a) or 0, x, w8, ws, src, out, 127.0) == 0
        return calls

    a, b = calls_of(8, 4096, 2)
    assert a == b
    assert a[2:7] == (1, 8, 4096, 82, 4192)  # E (a 2-D call), M, K, S, Kp
    assert a[11:13] == (127.0, tfq.ref.inv_qmax(127.0))
    assert a[15:18] == (0, 15, 9)  # tile, stages a split, splits
    assert a[13] == scratch.buffer("b1_q_exp", dev, 0).data_ptr()
    assert a[14] == scratch.buffer("b1_scale", dev, 0).data_ptr()
    acc = scratch.buffer("b1_acc", dev, 0)
    counters = scratch.buffer("split_k_counters", dev, 0)
    assert (a[18], a[19]) == (acc.data_ptr(), counters.data_ptr())
    assert acc.numel() >= 4 * 8 * 4096 and counters.numel() >= 4 * 16
    assert int(acc.count_nonzero()) == 0 and int(counters.count_nonzero()) == 0
    (c,) = calls_of(256, 151552, 1)
    assert c[15:20] == (1, 131, 1, None, None) and c[-2:] == (1, 7)
    assert scratch.buffer("b1_q_exp", dev, 0).numel() >= 256 * 4192
    scratch.clear()


@pytest.mark.parametrize("n,want", [(4096, 4096), (4100, 4100), (36, 36), (37, 48), (6, 16),
                                    (32001, 32016), (1, 16), (151552, 151552)])
def test_ragged_n_runs_padded_to_16(n, want):
    """A ragged N (N % 4 != 0) runs on the card zero-padded to a multiple of
    16 (B4/B5 on their TMA path), B1 and B6 any N % 16 != 0 (their TMA's
    rows), and the padding never crosses a 128- or 256-column
    tile, so the split of K, and every column below N, is that of an
    aligned call of the same columns; an N the kernels take as it is runs
    unpadded."""
    assert tqm.padded_cols(n) == want
    b1 = tqm.padded_cols(n, 16)
    assert b1 % 16 == 0 and b1 - n < 16 and b1 >= want
    for cols in (want, b1):
        assert math.ceil(cols / 128) == math.ceil(n / 128)
        assert math.ceil(cols / 256) == math.ceil(n / 256)
    assert tqm.tc_split_plan(4096, want) == tqm.tc_split_plan(4096, n)
    assert tqm.wo_split_plan(4178, want) == tqm.wo_split_plan(4178, n)
    for m in (8, 256):
        assert tfq.launch_plan(m, 4192, b1)[:3] == tfq.launch_plan(m, 4192, n)[:3]
        assert tw4.launch_plan(m, 66, 7, b1)[:3] == tw4.launch_plan(m, 66, 7, n)[:3]
    w8 = torch.ones((3, n), dtype=torch.int8)
    p = tqm.pad_cols(w8, want)
    assert p.shape == (3, want) and p.is_contiguous()
    assert torch.equal(p[:, :n], w8) and int(p[:, n:].count_nonzero()) == 0
    assert tqm.pad_cols(w8, n) is w8


# glm4-9b's W4A8 linear shapes (K + S, T, N) as to_w4a8(., 0.05) leaves the
# serving tree (H = (K+S)/2 byte rows of nibbles, T outlier rows), and B6's
# plan at a decode step (M = 8) and a prefill (M = 256) as (tile, stages a
# split, splits, accumulator bytes, counter bytes): the accumulator holds
# acc4 and acc8, [2, M, N].
B6_PLANS = {
    "wq/wo": ((4178, 209, 4096), (0, 10, 8, 262144, 64), (1, 25, 3, 8388608, 512)),
    "wk/wv": ((4178, 209, 256), (0, 5, 15, 16384, 4), (1, 5, 15, 524288, 32)),
    "w_gate/w_up": ((4178, 209, 13696), (0, 37, 2, 876544, 216), (1, 73, 1, 0, 0)),
    "w_down": ((13970, 699, 4096), (0, 31, 8, 262144, 64), (1, 81, 3, 8388608, 512)),
    "lm_head": ((4178, 209, 151552), (0, 73, 1, 0, 0), (1, 73, 1, 0, 0)),
}
# A decode row, a decode step, the tile switch, a verify of 8 x 5, prefill.
B6_MS = (1, 8, 9, 40, 256, 512)


def _b6_stages(ke, t):
    hp, tp = tw4.row_layout(ke // 2, t)
    return hp // 32, tp // 32


@pytest.mark.parametrize("name", list(B6_PLANS))
def test_b6_launch_plan_at_glm4_9b(name):
    """B6's plan at a decode step and a prefill: B1's tiles and split rule
    over its int4 stages (ceil(H / 32)) and outlier stages (ceil(T / 32)),
    at decode as many splits as one wave of 132 blocks holds (B1 reaches
    past it: 9 splits of wq/wo's 16 column tiles, where B6 takes 8); the
    lm_head's tiles fill the SMs alone, and at M = 256 its two-sum
    accumulator would be 310 MB, over the bound, so it is one split at
    either M."""
    (ke, t, n), decode, prefill = B6_PLANS[name]
    st4, st8 = _b6_stages(ke, t)
    assert tw4.launch_plan(8, st4, st8, n) == decode
    assert tw4.launch_plan(256, st4, st8, n) == prefill


@pytest.mark.parametrize("m", B6_MS)
@pytest.mark.parametrize("name", list(B6_PLANS))
def test_b6_launch_plan_covers_both_kinds_of_stages(name, m):
    """At every row count: B1's tile for M; each half of q2 and q8 padded
    to whole 32-row stages (no token box reads across the halves, and the
    row strides are multiples of 16 bytes, as the TMA wants); the splits
    cover the int4 stages and the outlier stages exactly, int4 first; with
    a split the accumulator holds both sums, [2, M, N], within its bound,
    and one counter per token tile and column tile; one split whenever the
    bound binds, and then neither."""
    (ke, t, n), _, _ = B6_PLANS[name]
    h = ke // 2
    hp, tp = tw4.row_layout(h, t)
    assert hp % 32 == 0 and 0 <= hp - h < 32 and tp % 32 == 0 and 0 <= tp - t < 32
    st4, st8 = hp // 32, tp // 32
    assert (st4, st8) == (math.ceil(h / 32), math.ceil(t / 32))
    tile, per, nsplit, acc_bytes, count_bytes = tw4.launch_plan(m, st4, st8, n)
    assert (tile, per, nsplit, acc_bytes, count_bytes) == tfq.split_plan(
        m, st4 + st8, n, 2, one_wave=m <= 8)
    assert tile == tfq.tile_for(m)
    assert (nsplit - 1) * per < st4 + st8 <= nsplit * per
    toks, cols, want = tfq._TILES[tile]
    tiles = math.ceil(m / toks) * math.ceil(n / cols)
    if tile == 0 and nsplit > 1:
        assert tiles * nsplit <= want == 132
    if 8 * m * n > tfq._MAX_ACC_BYTES:
        assert nsplit == 1
    if nsplit == 1:
        assert (acc_bytes, count_bytes) == (0, 0)
    else:
        assert per >= 4
        assert acc_bytes == 2 * 4 * m * n <= tfq._MAX_ACC_BYTES
        assert count_bytes == 4 * tiles


@pytest.mark.parametrize("h,t,want", [(2089, 209, (2112, 224)), (6985, 699, (7008, 704)),
                                      (155, 1, (160, 32)), (500, 33, (512, 64)),
                                      (64, 0, (64, 0)), (1, 32, (32, 32))])
def test_b6_row_layout_pads_to_whole_stages(h, t, want):
    """q2's halves and q8 at glm4-9b's shapes, an odd byte-row count (K+S =
    309 padded to 310), T = 1, 33 and 0, and one byte row; with T == 0 there
    are no outlier stages and the plan has one sum."""
    assert tw4.row_layout(h, t) == want
    if t == 0:
        assert tw4.launch_plan(8, want[0] // 32, 0, 4096) == tfq.split_plan(
            8, want[0] // 32, 4096, 1, one_wave=True)


def test_b6_launch_hands_the_plan_and_kept_scratch_to_the_kernel(monkeypatch):
    """``launch`` hands B6's entry point the plan, the row layout, the kept
    row scratch and, with a split, the kept two-sum accumulator and
    counters, both zeroed (a stand-in entry point records the calls;
    nothing launches); equal calls reuse the same buffers; a call with one
    split passes neither, and a call without outlier rows no q8."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("Stream", (), {"cuda_stream": 7}))
    scratch.clear()
    dev = torch.device("cpu")

    def calls_of(m, n, t, reps):
        x = torch.zeros((m, 4096), dtype=torch.bfloat16)
        w4 = torch.zeros((2089, n), dtype=torch.uint8)
        w8 = torch.zeros((t, n), dtype=torch.int8)
        ws, src = torch.ones(n), torch.zeros(82, dtype=torch.int32)
        oidx = torch.arange(t, dtype=torch.int32)
        out = torch.empty((m, n), dtype=torch.bfloat16)
        calls = []
        for _ in range(reps):
            assert tw4.launch(lambda *a: calls.append(a) or 0, x, w4, ws, w8, ws, src, oidx,
                              out, 127.0) == 0
        return calls

    a, b = calls_of(8, 4096, 209, 2)
    assert a == b
    assert a[2:6] == (1, 8, 4096, 82) and a[8] == 209 and a[13] == 4096  # E, M, K, S; T; N
    assert a[14:16] == (127.0, tref.inv_qmax(127.0))
    assert (a[17], a[19]) == (2112, 224)  # Hp, Tp
    assert a[21:24] == (0, 10, 8)  # tile, stages a split, splits
    assert a[16] == scratch.buffer("b6_q2", dev, 0).data_ptr()
    assert a[18] == scratch.buffer("b6_q8", dev, 0).data_ptr()
    assert a[20] == scratch.buffer("b6_scale", dev, 0).data_ptr()
    acc = scratch.buffer("b6_acc", dev, 0)
    counters = scratch.buffer("split_k_counters", dev, 0)
    assert (a[24], a[25]) == (acc.data_ptr(), counters.data_ptr())
    assert acc.numel() >= 2 * 4 * 8 * 4096 and counters.numel() >= 4 * 16
    assert int(acc.count_nonzero()) == 0 and int(counters.count_nonzero()) == 0
    assert scratch.buffer("b6_q2", dev, 0).numel() >= 8 * 2 * 2112
    (c,) = calls_of(256, 151552, 209, 1)
    assert c[21:26] == (1, 73, 1, None, None) and c[-2:] == (1, 7)
    assert scratch.buffer("b6_q2", dev, 0).numel() >= 256 * 2 * 2112
    (d,) = calls_of(8, 4096, 0, 1)
    assert d[8] == 0 and d[18] is None and d[19] == 0
    assert d[21:24] == tfq.split_plan(8, 66, 4096, 1, one_wave=True)[:3]
    scratch.clear()



# The tensor-core GEMM's tile plan (B5 and B4, ``tc_plan``): glm4-9b's B5
# shapes (S = 0) and B4's (S = 82, 274 at w_down, and after pad_to=128),
# at row counts below, at and above the prefill tile's row threshold M0 =
# 64 and its tile threshold (96 tiles: 129 rows at N = 4096): decode rows
# and steps, verifies of 8 x 5 and 8 x 8, prefill buckets.
TC_TILE_SHAPES = {**{f"B5 {name}": (k, 0, n) for name, ((k, n), _) in TC_PLANS.items()},
                  **{f"B4 {name}": ksn for name, (ksn, _) in B4_TC_PLANS.items()}}
TC_TILE_MS = (1, 8, 16, 17, 32, 40, 63, 64, 65, 72, 128, 129, 256, 512)


def _tc_plan(m, k, s, n):
    return tqm.tc_plan(m, k, tqm.tc_rows(k, s), n, tqm._MAX_PART_BYTES)


@pytest.mark.parametrize("m", TC_TILE_MS)
@pytest.mark.parametrize("name", list(TC_TILE_SHAPES))
def test_tc_plan_picks_the_tile_from_m(name, m):
    """Both tiles take ``tc_split_plan(kv, n)`` unchanged. A call takes the
    prefill tile from M0 = 64 rows on when its 64 x 128 tiles reach
    ``_TC_PREFILL_MIN_TILES``: one launch that walks every split in time,
    with no workspace and no counter. Every other call keeps the decode
    tile and its launch plan as they were: its splits in space, one a
    block, in row chunks that bound the workspace, with its counters."""
    k, s, n = TC_TILE_SHAPES[name]
    kv = tqm.tc_rows(k, s)
    tile, k_chunk, nsplit, rows, part_bytes, count_bytes = _tc_plan(m, k, s, n)
    assert (k_chunk, nsplit) == tqm.tc_split_plan(kv, n)
    assert (tqm._TC_PREFILL_MIN_ROWS, tqm._TC_PREFILL_MIN_TILES) == (64, 96)
    tiles = math.ceil(m / 64) * math.ceil(n / 128)
    if m >= 64 and tiles >= 96:
        assert (tile, rows, part_bytes, count_bytes) == (tqm.TC_PREFILL, m, 0, 0)
    else:
        assert tile == tqm.TC_DECODE
        assert (k_chunk, nsplit, rows, part_bytes, count_bytes) == tqm._tc_launch_plan(
            m, kv, n, tqm._MAX_PART_BYTES)
        if nsplit > 1:  # one split a block: the workspace and a counter a tile
            assert 0 < part_bytes == 4 * nsplit * rows * n <= tqm._MAX_PART_BYTES
            assert count_bytes == 4 * math.ceil(rows / 8) * math.ceil(n / 128)


# The tile the plan gives glm4-9b's five shape classes (B5's S = 0 and B4's
# tails alike) at a decode step, a verify of 8 x 5 and prefills of 64, 128,
# 129 and 256 rows: the prefill tile from M0 on where its tiles give most
# SMs a block (w_gate/w_up and the lm_head from 64 rows: 107 and 1184 column
# tiles; wq/wo and w_down from 129: 3 x 32), the decode tile for wk/wv (2
# column tiles).
TC_TILE_AT = {
    "wq/wo": ("decode", "decode", "decode", "decode", "prefill", "prefill"),
    "wk/wv": ("decode", "decode", "decode", "decode", "decode", "decode"),
    "w_gate/w_up": ("decode", "decode", "prefill", "prefill", "prefill", "prefill"),
    "w_down": ("decode", "decode", "decode", "decode", "prefill", "prefill"),
    "lm_head": ("decode", "decode", "prefill", "prefill", "prefill", "prefill"),
}


@pytest.mark.parametrize("name", list(TC_TILE_SHAPES))
def test_tc_plan_at_glm4_9b(name):
    k, s, n = TC_TILE_SHAPES[name]
    want = TC_TILE_AT[name.split(" ")[1]]
    got = tuple(tqm.TC_TILE_NAMES[_tc_plan(m, k, s, n)[0]] for m in (8, 40, 64, 128, 129, 256))
    assert got == want


@pytest.mark.parametrize("k,s,n", [(1000, 0, 200), (130, 0, 336), (1000, 70, 200),
                                   (130, 7, 336)])
def test_tc_plan_keeps_what_the_tma_cannot_take_on_the_decode_tile(monkeypatch, k, s, n):
    """N % 16 != 0 or K % 8 != 0 (no serving shape) stays on the decode
    tile's non-TMA branch at any M, even where the row and tile thresholds
    would admit the prefill tile; the prefill tile has no such branch."""
    monkeypatch.setattr(tqm, "_TC_PREFILL_MIN_TILES", 1)
    for m in (64, 256, 8192):
        plan = _tc_plan(m, k, s, n)
        assert plan[0] == tqm.TC_DECODE
        assert plan[1:] == tqm._tc_launch_plan(m, tqm.tc_rows(k, s), n, tqm._MAX_PART_BYTES)
    # The same call with the TMA's alignment takes the prefill tile.
    assert _tc_plan(8192, k + (-k) % 8, s, n + (-n) % 16)[0] == tqm.TC_PREFILL


def _decode_chains(nst):
    """The decode tile's sums within a split of ``nst`` stages
    (``csrc/wo_tc_gemm.cuh``): warp w takes ``mine`` stages w, w + 4, ... in
    order, and the 4 warps' sums are added in order w = 0..3."""
    chains = []
    for w in range(4):
        mine = (nst - w + 3) // 4 if nst > w else 0
        chains.append([w + 4 * i for i in range(mine)])
    return chains


def _prefill_walk(kv, k_chunk, nsplit):
    """The (split, chain, stage) sequence of a prefill-tile block
    (``csrc/wo_tc_prefill.cuh``): every split z in order; within it, warp
    group c sums chain c, the stages c, c + 4, ... (its loop over ``s``, and
    its ring's cursor ``PfChainCursor``), and the chain sums are added in
    order c = 0..3 (the named barriers 1-4)."""
    walk = []
    for z in range(nsplit):
        nst = math.ceil((min(kv, (z + 1) * k_chunk) - z * k_chunk) / 32)
        for c in range(4):
            walk += [(z, c, s) for s in range(c, nst, 4)]
    return walk


@pytest.mark.parametrize("name", list(TC_TILE_SHAPES))
def test_prefill_walk_is_the_decode_tiles_chain_order(name):
    """The stage order the plan hands the prefill kernel (its split of the
    contraction, walked in time) visits every stage of every split once,
    splits in order z = 0..nsplit-1; within a split chain c holds the decode
    tile's warp c's stages (s % 4 == c, ascending), and the chains are added
    in the order the decode tile adds its warps' sums."""
    k, s, n = TC_TILE_SHAPES[name]
    kv = tqm.tc_rows(k, s)
    k_chunk, nsplit = _tc_plan(512, k, s, n)[1:3]
    walk = _prefill_walk(kv, k_chunk, nsplit)
    assert [z for z, _, _ in walk] == sorted(z for z, _, _ in walk)
    seen = Counter((z, st) for z, _, st in walk)
    total = 0
    for z in range(nsplit):
        nst = math.ceil((min(kv, (z + 1) * k_chunk) - z * k_chunk) / 32)
        total += nst
        assert all(seen[(z, st)] == 1 for st in range(nst))
        chains = [[st for zz, c, st in walk if zz == z and c == cc] for cc in range(4)]
        assert chains == _decode_chains(nst)
        assert all(st % 4 == c for zz, c, st in walk if zz == z)
    assert sum(seen.values()) == total
    assert (nsplit - 1) * k_chunk < kv <= nsplit * k_chunk and k_chunk % 32 == 0


def test_tc_launch_hands_the_plan_and_kept_scratch_to_the_kernel(monkeypatch):
    """``launch_tc`` hands B5's and B4's entry point the plan's tile and
    split and, for the decode tile with a split, its kept workspace and
    counters (a stand-in entry point records the calls; nothing launches):
    a prefill-tile call one launch with neither; a decode-tile call the kept
    split-K workspace and the kept counters, zeroed, in row chunks of the
    workspace bound."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("Stream", (), {"cuda_stream": 7}))
    scratch.clear()
    dev = torch.device("cpu")

    def calls_of(m, n, s):
        x = torch.zeros((m, 4096), dtype=torch.bfloat16)
        out = torch.empty((m, n), dtype=torch.bfloat16)
        ws = torch.ones(n)
        args = (s, 111, 222, 333) if s else (333,)  # B4: S, src_tail, tail_mult; w8
        calls = []
        assert tqm.launch_tc(lambda *a: calls.append(a) or 0, x, out, None, ws,
                             tqm.tc_rows(4096, s), *args) == 0
        return calls, 4 + len(args) + 2  # the index of N

    # B5 wq/wo at M = 256: the prefill tile, its 9 splits in one launch.
    (c,), at = calls_of(256, 4096, 0)
    assert c[1:5] == (1, 256, 4096, 333) and c[5] is None
    assert c[at:] == (4096, 480, 9, tqm.TC_PREFILL, None, None, c[-3], 1, 7)
    # B4 w_gate/w_up at a prefill of 64 rows: the prefill tile.
    (c,), at = calls_of(64, 13696, 82)
    assert c[4:8] == (82, 111, 222, 333)
    assert c[at:at + 6] == (13696, 1408, 3, tqm.TC_PREFILL, None, None)
    # B5's lm_head, one split: the prefill tile too.
    (c,), at = calls_of(64, 151552, 0)
    assert c[at:at + 6] == (151552, 4096, 1, tqm.TC_PREFILL, None, None)
    # B4 wk/wv at M = 256: the decode tile, one of its 15 splits a block.
    (c,), at = calls_of(256, 256, 82)
    part = scratch.buffer("split_k", dev, 0)
    counters = scratch.buffer("split_k_counters", dev, 0)
    assert c[at:at + 6] == (256, 288, 15, tqm.TC_DECODE, part.data_ptr(), counters.data_ptr())
    assert part.numel() >= 4 * 15 * 256 * 256 and counters.numel() >= 4 * 32 * 2
    assert int(counters.count_nonzero()) == 0
    # A smaller workspace bound: the decode tile's row chunks, one buffer.
    monkeypatch.setattr(tqm, "_MAX_PART_BYTES", 4 * 15 * 100 * 256)
    calls, at = calls_of(256, 256, 82)
    assert [a[2] for a in calls] == [100, 100, 56]
    assert {a[at + 3:at + 6] for a in calls} == {
        (tqm.TC_DECODE, scratch.buffer("split_k", dev, 0).data_ptr(),
         scratch.buffer("split_k_counters", dev, 0).data_ptr())}
    # The prefill tile's calls do not chunk: no workspace bounds them.
    (c,), at = calls_of(512, 4096, 82)
    assert c[2] == 512 and c[at + 3:at + 6] == (tqm.TC_PREFILL, None, None)
    scratch.clear()
