"""The host-side plans of the port's CUDA kernels, on the CPU.

The kernels run only on the card, but what their wrappers decide before a
launch is plain Python: B2's split of the block table into chunks and the
size of its merge workspace, the tensor-core tiles and split of K that B5
and B4 share (B4's over the virtual rows of its OCS tail), the workspaces
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

from repro_torch.kernels import ocs_matmul as tom
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref
from repro_torch.kernels import scratch

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
    assert [c[1] for c in calls] == [12, 12, 12, 4]  # rows a launch
    for c in calls:
        assert c[2:7] == (4096, 82, 111, 222, 333)  # K, S, src_tail, tail_mult, w8
        assert c[7] is None and c[8] == ws.data_ptr()
        assert c[9:12] == (256, 288, 15)  # N, k_chunk, nsplit
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
