"""The NMS kernel's plan and a numpy emulation of its algorithm
(``csrc/nms.cu``) against the plain version and the JAX package.

The kernel cannot run here, so what surrounds it is checked in Python:
- the plan (``ops/kernels/nms.plan``): the bytes of each shared region,
  blocks an SM and waves, for the layout the library reports on the H100;
- the emulation: the bitonic sort with the kernel's schedule of strides
  (through shared memory, between a thread's registers, by shuffles) over
  the 64-bit keys, the rank-order staging, the mask as 32x32 bit tiles on
  and above the diagonal in the kernel's rotated word layout, the sweep
  by word, and the output by slot.  Rows and columns past the valid
  candidates hold random boxes, as the kernel's shared memory holds
  whatever was there, to show that they change nothing.
Every case is held bit for bit against ``nms_keep_scores_plain``, the JAX
package's Pallas kernel in interpret mode, and by value against its
sequential ``nms_reference`` (float64, which knows no -0.0).  The cases
are ``chip_smoke.nms_edge_cases``' at fewer instances, signed zeros, and
boxes on a grid at thresholds from below 0 to above 1 (the kernel leaves
out one clamp of the pair test where iou_t >= 0).
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from paddle_lite_tpu.ops.kernels import nms as r_nms
from paddle_lite_tpu_torch.ops.kernels import _build
from paddle_lite_tpu_torch.ops.kernels import nms as kn

IOU_T, SCORE_T = 0.45, 0.01
# plt_nms_layout on the H100 (chip_smoke.py prints it in phase 1)
H100 = kn.Layout(threads=128, blocks_per_sm=7, sms=132, smem_per_sm=233472,
                 smem_reserved=1024, smem_per_block=232448)
NO_KEY = np.uint64(0xffffffff << 32)  # the high word of an invalid key


# ---- the plan ----------------------------------------------------------------

def test_plan_at_the_ssd_path():
    """bucket3@176's k = 528 for 32 images x 21 classes: 21 KB a block,
    seven blocks an SM (by registers), so the 672 instances are one wave."""
    p = kn.plan(528, H100)
    assert (p.words, p.sort_n, p.per_thread) == (17, 1024, 8)
    assert (p.box_bytes, p.area_bytes, p.rank_bytes, p.kept_bytes) == (8704, 2176, 2176, 80)
    assert p.count_bytes == 96  # 4 warps' counts, the kept count, 17 removed words
    assert p.region_bytes == 8192  # the keys; then 17 diagonal tiles and 544 ranks
    assert p.smem_bytes == 21424 and p.blocks_per_sm == 7
    assert kn.waves(672, p, H100) <= 1.0


@pytest.mark.parametrize("k", [1, 31, 32, 33, 127, 128, 129, 400, 528, 1000, 1024, 1025, 1600])
def test_plan_regions(k):
    p = kn.plan(k, H100)
    assert p.words == -(-k // 32) and p.sort_n >= max(k, kn.THREADS)
    assert p.sort_n & (p.sort_n - 1) == 0 and p.per_thread * p.threads == p.sort_n
    assert p.region_bytes >= max(8 * p.sort_n, 4 * 32 * p.words * 2)
    assert p.kept_bytes % 16 == 0 and p.box_bytes % 16 == 0  # float4 areas and boxes
    assert p.count_bytes >= 4 * (kn.WARPS + 1 + p.words) and p.count_bytes % 16 == 0
    assert p.smem_bytes == (p.box_bytes + p.area_bytes + p.rank_bytes + p.kept_bytes
                            + p.count_bytes + p.region_bytes)
    per_block = p.smem_bytes + H100.smem_reserved
    assert p.blocks_per_sm == min(H100.blocks_per_sm, H100.smem_per_sm // per_block) >= 1


@pytest.mark.parametrize("k,lay,match", [
    (4096, H100, "4096 sort keys"), (2049, H100, "4096 sort keys"), (0, H100, "k must be"),
    (1024, H100._replace(smem_per_block=32768), "33056 B of shared memory")])
def test_plan_refuses_what_the_kernel_cannot_take(k, lay, match):
    """The sort holds 2048 keys (16 a thread), and at k = 4096 the block
    would still fit the H100's shared memory, so the keys are the limit
    there (the card's test of k = 4096 expects them named); a card with
    less shared memory a block refuses sooner, naming shared memory."""
    with pytest.raises(ValueError, match=match) as e:
        kn.plan(k, lay)
    assert ("sort keys" in str(e.value)) == ("sort keys" in match)
    assert ("shared memory" in str(e.value)) == ("shared memory" in match)


# ---- the emulation -----------------------------------------------------------

def _ordered(s: np.ndarray) -> np.ndarray:
    """csrc/nms.cu's ordered(): fp32 -> uint32 increasing with the value,
    -0.0 as +0.0."""
    s = np.where(s == 0, np.float32(0), s).astype(np.float32)
    u = s.view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def _ce(v: np.ndarray, size: int, stride: int, strides: list) -> None:
    """One bitonic compare-exchange stage over all pairs (e, e ^ stride),
    on the flat array (the kernel's stages through shared memory)."""
    strides.append((size, stride))
    e = np.arange(v.size)
    lo = e[(e & stride) == 0]
    hi = lo + stride
    a, c = v[lo].copy(), v[hi].copy()
    swap = (a > c) == ((lo & size) == 0)
    v[lo] = np.where(swap, c, a)
    v[hi] = np.where(swap, a, c)


def sort_split(k, sort_n, per_thread):
    """csrc/nms.cu's sort_split: k's largest power of two a and the rest,
    padded to pb >= 32 J keys, sorted apart; (sort_n, 0) where k is a
    power of two or a < 32 J."""
    a = 1 << (k.bit_length() - 1)
    if a == k or a < 32 * per_thread:
        return sort_n, 0
    pb = 32 * per_thread
    while pb < k - a:
        pb *= 2
    return a, pb


def _sort_part(v: np.ndarray, J: int, register_sort: bool):
    """sort_keys<J> on one part (a view), thread t of the part holding
    elements J t + j: the kernel's stages in its order, each with the
    kernel's own direction and partner arithmetic (strides of 32 J and more
    through shared memory, then between lanes by shuffles, then between a
    thread's registers); returns the stages it ran."""
    reg = v.reshape(v.size // J, J)  # a view: thread, register
    tid = np.arange(v.size // J)[:, None]
    strides = []
    shared = 32 * J if register_sort else 1
    size = 2
    while size <= v.size:
        stride = size >> 1
        while stride >= shared:
            _ce(v, size, stride, strides)
            stride >>= 1
        if register_sort:
            while stride >= J:  # __shfl_xor_sync(v[j], m) within the warp
                strides.append((size, stride))
                m = stride // J
                partner = (tid ^ m)[:, 0]
                assert ((partner >> 5) == (tid[:, 0] >> 5)).all()
                other = reg[partner]
                keep_min = ((tid & m) == 0) == (((J * tid) & size) == 0)
                reg[...] = np.where((other < reg) == keep_min, other, reg)
                stride >>= 1
            sj = J // 2
            while sj >= 1:
                if sj <= stride:
                    strides.append((size, sj))
                    for j in range(J):
                        if j & sj:
                            continue
                        a, c = reg[:, j].copy(), reg[:, j | sj].copy()
                        swap = (a > c) == (((J * tid[:, 0] + j) & size) == 0)
                        reg[:, j] = np.where(swap, c, a)
                        reg[:, j | sj] = np.where(swap, a, c)
                sj >>= 1
        size <<= 1
    return strides


def below(arr: np.ndarray, x) -> int:
    """csrc/nms.cu's below(): the keys of sorted `arr` (a power of two
    long, all keys different) below x, by its binary search."""
    c, s = 0, arr.size >> 1
    while s >= 1:
        if arr[c + s - 1] < x:
            c += s
        s >>= 1
    return c + int(arr[c] < x)


def test_below_counts_the_keys_below():
    rng = np.random.default_rng(4)
    for n in (1, 2, 16, 256, 512):
        arr = np.sort(rng.choice(10 * n, n, replace=False)).astype(np.uint64)
        for x in np.concatenate([arr, arr + 1, [0, 10 * n + 5]]).astype(np.uint64):
            assert below(arr, x) == int(np.searchsorted(arr, x))


def sort_emulated(v: np.ndarray, per_thread: int, k: int, register_sort: bool = True):
    """The kernel's sort of the P keys `v` for k candidates: each part
    sorted on its own, then the ranks merged (a key's place in its part
    plus the other part's keys below it); returns each part's stages."""
    a, pb = sort_split(k, v.size, per_thread)
    stages = [_sort_part(v[:a], per_thread, register_sort)]
    if pb:
        stages.append(_sort_part(v[a:a + pb], per_thread, register_sort))
        lo, hi = v[:a].copy(), v[a:a + pb].copy()
        rank = np.concatenate([np.arange(a) + [below(hi, x) for x in lo],
                               np.arange(pb) + [below(lo, x) for x in hi]])
        assert np.array_equal(np.sort(rank), np.arange(a + pb))
        v[rank] = np.concatenate([lo, hi])
    return stages


def _f32(x):
    return np.float32(x)


def _row_bits(rb, ra, cb, ca, t_iou):
    """row_bits for rows (n, 4), (n,) against 32 columns (32, 4), (32,):
    (n,) words, bit q = sup(row, column q), with the kernel's clamps."""
    lane = np.arange(32, dtype=np.uint64)
    rb, ra, cb, ca = rb[:, None, :], ra[:, None], cb[None], ca[None]
    ix = np.maximum(np.minimum(rb[..., 2], cb[..., 2]) - np.maximum(rb[..., 0], cb[..., 0]),
                    _f32(0))
    iy = np.minimum(rb[..., 3], cb[..., 3]) - np.maximum(rb[..., 1], cb[..., 1])
    if not t_iou >= 0:  # row_bits<true>; from 0 up iy stays unclamped
        iy = np.maximum(iy, _f32(0))
    inter = ix * iy
    sup = inter > t_iou * ((ra + ca) - inter)
    return (sup.astype(np.uint64) << lane[None, :]).sum(1).astype(np.uint32)


def emulate(boxes, scores, iou_t, score_t, diag_shift=0, rng=None, tests=None, needed=None):
    """The kernel on one instance at a time: (G, k, 4), (G, k) fp32 ->
    (G, k) fp32.  `diag_shift` != 0 masks the diagonal tile by c > r +
    shift (a broken kernel).  `tests`, a list, gets each instance's pair
    tests; `needed`, a list, each instance's pairs of a kept rank and a
    later valid one (the pairs greedy NMS must test)."""
    rng = rng or np.random.default_rng(0)
    g, k = scores.shape
    p = kn.plan(k, H100)
    t_iou, t_score = _f32(iou_t), _f32(score_t)
    out = np.empty((g, k), np.float32)
    lane = np.arange(32)
    for gi in range(g):
        s = scores[gi]
        valid = s > t_score
        keys = NO_KEY | np.arange(p.sort_n, dtype=np.uint64)  # all keys differ
        slot = np.arange(k, dtype=np.uint64)
        keys[:k] = np.where(valid, (~_ordered(s)).astype(np.uint64) << np.uint64(32) | slot,
                            keys[:k])
        ref = np.sort(keys)
        sort_emulated(keys, p.per_thread, k)
        assert np.array_equal(keys, ref)  # the network sorts
        nv = int(valid.sum())
        # 2. staging by rank; ranks past nv hold whatever is there
        rows = 32 * p.words
        box = rng.uniform(-1, 2, (rows, 4)).astype(np.float32)
        area = rng.uniform(0, 1, rows).astype(np.float32)
        rank_of = np.full(k, -1)
        order = (keys[:nv] & np.uint64(0xffffffff)).astype(np.int64)
        box[:nv] = boxes[gi, order]
        b = box[:nv]
        area[:nv] = np.maximum(b[:, 2] - b[:, 0], _f32(0)) * np.maximum(b[:, 3] - b[:, 1], _f32(0))
        rank_of[order] = np.arange(nv)
        # 3. the diagonal tiles, masked by c > r
        words = -(-nv // 32)
        cols = [slice(32 * u, 32 * u + 32) for u in range(words)]
        above = (lane[None, :] > lane[:, None] + diag_shift)
        diag = [_row_bits(box[c], area[c], box[c], area[c], t_iou)
                & (above.astype(np.uint64) << lane[None, :].astype(np.uint64)).sum(1).astype(np.uint32)
                for c in cols]
        # 4. word by word: the kept rows so far against the word's columns,
        # then the settle; the kept ranks appended
        krow, n_tests = [], 1024 * words
        kept = rng.integers(0, 2 ** 32, p.words, dtype=np.uint64).astype(np.uint32)
        for u, c in enumerate(cols):
            r = 0
            if krow:
                r = int(np.bitwise_or.reduce(_row_bits(box[krow], area[krow], box[c], area[c],
                                                       t_iou)))
                n_tests += 1024 * -(-len(krow) // 32)
            for q in range(32):
                if not (r >> q) & 1:
                    r |= int(diag[u][q])
            left = nv - 32 * u
            kw = ~r & (0xffffffff if left >= 32 else (1 << left) - 1) & 0xffffffff
            kept[u] = kw
            krow += [32 * u + q for q in range(32) if (kw >> q) & 1]
        if tests is not None:
            tests.append(n_tests)
        if needed is not None:
            needed.append(sum(nv - 1 - r for r in krow))
        # 5. out by slot
        r = np.where(valid, rank_of, 0)
        keep = valid & (((kept[r >> 5] >> (r & 31).astype(np.uint32)) & 1) == 1)
        out[gi] = s * keep.astype(np.float32)
    return out


def _cand(rng, g, k):
    c = rng.uniform(0.1, 0.9, (g, k, 2))
    wh = rng.uniform(0.02, 0.35, (g, k, 2))
    b = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    sc = rng.uniform(0, 1, (g, k)).astype(np.float32)
    sc[:, ::3] *= 0.005
    return b, sc


def edge_cases():
    """chip_smoke.nms_edge_cases' cases at fewer instances, SSD's k = 528,
    and signed zero scores (score_t below 0)."""
    rng = np.random.default_rng(8)
    cases = []
    b, sc = _cand(rng, 2, 528)
    sc[:, 40:80] = sc[:, 7:8]
    cases.append(("ties_unsorted", b, sc, SCORE_T))
    b, sc = _cand(rng, 2, 528)
    cases.append(("sorted", b, -np.sort(-sc, axis=1), SCORE_T))
    b, sc = _cand(rng, 2, 528)
    sc[::2] = 0.004
    cases.append(("all_invalid_every_other", b, sc, SCORE_T))
    b, sc = _cand(rng, 2, 528)
    b[:, 100:300] = b[:, 100:101]
    sc[:, 150:250] = 0.7
    cases.append(("identical_boxes_and_ties", b, sc, SCORE_T))
    for g, k in ((2, 400), (3, 33), (3, 1), (1, 1024), (2, 64)):
        b, sc = _cand(rng, g, k)
        cases.append((f"k{k}", b, sc, SCORE_T))
    b, sc = _cand(rng, 2, 100)
    sc[:, ::4] = 0.0
    sc[:, 1::4] = -0.0
    cases.append(("signed_zeros", b, sc, -1.0))
    return cases


def grid_cases():
    """Boxes on a grid of eighths: touching edges, zero widths and heights,
    -0.0 coordinates, for iou_t from below 0 to above 1 (the kernel leaves
    out iy's clamp from iou_t = -0.0 up)."""
    rng = np.random.default_rng(9)
    g, k = 3, 160
    lo = rng.integers(-2, 8, (g, k, 2)) / 8.0
    b = np.concatenate([lo, lo + rng.integers(0, 4, (g, k, 2)) / 8.0], -1).astype(np.float32)
    b[b == 0] = -0.0
    sc = rng.integers(1, 40, (g, k)).astype(np.float32) / 40
    return [(f"grid_iou{t}", b, sc, t) for t in (-0.5, -0.0, 0.0, 0.3, 0.45, 1.0, 1.5)]


GRID = grid_cases()


@pytest.mark.parametrize("case", GRID, ids=[c[0] for c in GRID])
def test_emulated_kernel_on_a_grid_of_boxes(case):
    _, boxes, scores, iou_t = case
    got = emulate(boxes, scores, iou_t, SCORE_T)
    plain = kn.nms_keep_scores_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                     iou_t=iou_t, score_t=SCORE_T).numpy()
    pallas = np.asarray(r_nms.nms_keep_scores(jnp.asarray(boxes), jnp.asarray(scores),
                                              iou_t=iou_t, score_t=SCORE_T, interpret=True))
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), pallas.view(np.int32))


CASES = edge_cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_emulated_kernel_equals_plain_and_jax(case):
    _, boxes, scores, score_t = case
    got = emulate(boxes, scores, IOU_T, score_t)
    plain = kn.nms_keep_scores_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                     iou_t=IOU_T, score_t=score_t).numpy()
    pallas = np.asarray(r_nms.nms_keep_scores(jnp.asarray(boxes), jnp.asarray(scores),
                                              iou_t=IOU_T, score_t=score_t, interpret=True))
    greedy = r_nms.nms_reference(boxes, scores, iou_t=IOU_T, score_t=score_t)
    np.testing.assert_array_equal(got.view(np.int32), plain.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), pallas.view(np.int32))
    np.testing.assert_array_equal(got, greedy)


def test_the_cases_suppress_and_tie():
    """The data exercise what the kernel's parts decide: suppression inside
    the diagonal tile and across tiles, tied scores, all-invalid instances."""
    by = {c[0]: c for c in CASES}
    _, b, sc, st = by["identical_boxes_and_ties"]
    got = emulate(b, sc, IOU_T, st)
    # 200 identical boxes (100 tied at 0.7): at most one kept an instance
    assert ((got[:, 100:300] > 0).sum(1) <= 1).all() and (got[:, 100:300] > 0).any()
    _, b, sc, st = by["all_invalid_every_other"]
    assert (emulate(b, sc, IOU_T, st)[::2] == 0).all()
    _, b, sc, st = by["signed_zeros"]
    got = emulate(b, sc, IOU_T, st)
    assert np.signbit(got[:, 1::4]).all()      # -0.0 stays -0.0, kept or not


def test_an_off_by_one_diagonal_fails():
    """Dropping the pair (r, r + 1) from the diagonal tile changes the
    result: the emulation, and so this test, can see the diagonal's mask."""
    _, b, sc, st = CASES[0]
    plain = kn.nms_keep_scores_plain(torch.from_numpy(b), torch.from_numpy(sc),
                                     iou_t=IOU_T, score_t=st).numpy()
    assert np.array_equal(emulate(b, sc, IOU_T, st), plain)
    assert not np.array_equal(emulate(b, sc, IOU_T, st, diag_shift=1), plain)


@pytest.mark.parametrize("k", [1, 5, 33, 100, 128, 129, 300, 400, 528, 1000, 1024, 1025, 2048])
def test_the_sort_runs_every_bitonic_stage_once(k):
    """Each part of the sort runs the bitonic network of its size, each
    stage once and in order, with the kernel's three kinds of stride and
    with every stride through shared memory (the ablation); the merged
    ranks give the sorted keys.  k = 528 splits into 512 and 256 keys."""
    p = kn.plan(k, H100)
    a, pb = sort_split(k, p.sort_n, p.per_thread)
    assert (a, pb) == ((512, 256) if k == 528 else (a, pb))
    assert a + pb <= p.sort_n and a % (32 * p.per_thread) == 0 and pb % (32 * p.per_thread) == 0

    def network(n):
        return [(1 << x, 1 << y) for x in range(1, n.bit_length()) for y in range(x - 1, -1, -1)]

    for register_sort in (True, False):
        v = np.random.default_rng(k).permutation(p.sort_n).astype(np.uint64)
        stages = sort_emulated(v, p.per_thread, k, register_sort)
        assert stages == [network(a)] + ([network(pb)] if pb else [])
        assert np.array_equal(v[:a + pb], np.sort(v[:a + pb]))
        if not pb:
            assert np.array_equal(v, np.arange(p.sort_n))


# ---- the per-device set-up and the bound --------------------------------------

class _FakeLib:
    def __init__(self):
        self.device = 0
        self.prepared = []

    def plt_nms_prepare(self):
        self.prepared.append(self.device)
        return 0


def test_prepare_runs_once_per_device(monkeypatch):
    assert _build.PREPARE["nms"] == "plt_nms_prepare"
    lib = _FakeLib()
    monkeypatch.setattr(_build, "_LIBS", {"nms": lib})
    monkeypatch.setattr(_build, "_PREPARED", set())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: lib.device)
    for dev in (0, 0, 1, 1, 0):
        lib.device = dev
        assert _build.load("nms") is lib
    assert lib.prepared == [0, 1]


def test_the_source_has_no_function_local_static():
    src = (_build.CSRC / "nms.cu").read_text()
    assert "static int" not in src and "static long" not in src
    assert "static const" not in src and "static cudaError_t" not in src
    launch = src[src.index('extern "C" int plt_nms_keep'):]
    assert "cudaFuncSetAttribute" not in launch and "cudaDeviceGetAttribute" not in launch


def test_the_wrapper_asks_nothing_of_the_card_per_call():
    src = inspect.getsource(kn.nms_keep_scores)
    assert "get_device_properties" not in src and "plt_nms_smem_bytes" not in src


def test_chip_smoke_bounds_nms_at_the_fp32_instruction_rate(monkeypatch):
    """check_nms charges 13 operations for each pair greedy NMS must test
    (a kept rank against every later valid rank: a removed rank suppresses
    nothing) at the rate it is given, and phase_ssd gives it the fp32 rate
    unscaled.  The kernel's schedule, modeled, is reported beside it and
    tests at least those pairs."""
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, "eager_ms", lambda fn, **kw: 0.0)
    monkeypatch.setattr(chip_smoke, "DEV", torch.device("cpu"))
    b, sc = _cand(np.random.default_rng(3), 3, 96)
    rate = 132 * 128 * 1980e6
    row = chip_smoke.check_nms("t", torch.from_numpy(b), torch.from_numpy(sc), IOU_T,
                               SCORE_T, rate, timed=True)
    nv = (sc > np.float32(SCORE_T)).sum(1)
    pairs = float((nv * (nv - 1) / 2).sum())
    assert row["pair_tests"] == pairs
    tests, needed = [], []
    emulate(b, sc, IOU_T, SCORE_T, tests=tests, needed=needed)
    assert row["modeled_pair_tests"] == sum(tests) >= sum(needed)
    assert row["needed_pair_tests"] == sum(needed) < pairs
    assert row["ops_ms"] == pytest.approx(1e3 * 13 * sum(needed) / rate, rel=1e-12)
    assert "kernel_pair_tests" not in row
    src = inspect.getsource(chip_smoke.phase_ssd)
    assert "2 * fma_per_s" not in src and "fp32_ops" not in src
    # run 15's 93,494,016 pair tests at 132 SMs x 128 lanes x 1980 MHz
    assert 1e3 * 13 * 93494016 / rate == pytest.approx(0.0363, abs=5e-5)
