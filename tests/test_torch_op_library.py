"""The rest of the op library: the 93 op names the port lacked, each held to
the reference's ``"xla"`` impl on its case from ``testing/op_cases.py``.

Each op runs as a one-op graph through both packages' eager executors on
the CPU (the one-op harness of ``test_torch_fluid_ops.run_both``; the
reference's graph is the port's carried across by the shared artifact
meta, which also carries nested control-flow graphs), with that file's
tolerance rule: data movement, integer and boolean results and one IEEE
operation an element bit for bit; transcendental functions, reductions and
sums in another order within rtol 1e-5 / atol 1e-6 (``OpTestCase.exact``).

Where the port departs from a reference fault, the test says so and holds
the port to the correct result: ``max_pool2d_with_index`` with padding and
``roi_align`` with more than one image.
"""

import jax
import numpy as np
import pytest
import torch

import paddle_lite_tpu as R
import paddle_lite_tpu_torch as P
from paddle_lite_tpu.core.registry import OPS as ROPS
from paddle_lite_tpu.formats import artifact as r_artifact
from paddle_lite_tpu_torch.core.registry import OPS as POPS
from paddle_lite_tpu_torch.formats import artifact as p_artifact
from paddle_lite_tpu_torch.ops import longtail
from paddle_lite_tpu_torch.testing import arena, op_cases
from test_torch_fluid_ops import assert_same

CPU = torch.device("cpu")
CASES = op_cases.cases()

NEW_OPS = [
    "add_n", "affine_channel", "anchor_generator", "arg_min", "argsort", "assign_value",
    "beam_search", "bitwise_and", "bitwise_not", "bitwise_or", "bitwise_xor", "bmm",
    "box_clip", "brelu", "calib", "clip_by_norm", "conditional_block", "cos_sim", "crop",
    "crop_tensor", "cumsum", "expand", "expand_as", "expand_as_v2", "expand_v2", "feed",
    "fetch", "fill_any_like", "fill_constant_batch_size_like", "fill_zeros_like", "flip",
    "gather", "gather_nd", "gaussian_random", "generate_proposals", "grid_sampler",
    "group_norm", "gru_unit", "hard_shrink", "im2sequence", "increment", "index_select",
    "instance_norm", "io_copy", "io_copy_once", "layout", "linspace", "lod_reset",
    "log_softmax", "lstm", "matmul_v2", "matrix_nms", "max_pool2d_with_index", "mean",
    "merge_lod_tensor", "meshgrid", "norm", "one_hot", "one_hot_v2", "p_norm", "pad2d",
    "pad3d", "pixel_unshuffle", "pow", "range", "reverse", "roi_align", "roll", "scatter",
    "scatter_nd_add", "sequence_concat", "sequence_expand", "sequence_mask", "sequence_pool",
    "sequence_reverse", "sequence_softmax", "shuffle_channel", "size", "softshrink",
    "space_to_depth", "split_lod_tensor", "strided_slice", "subgraph", "sum", "tanh_shrink",
    "thresholded_relu", "tile", "top_k", "unbind", "uniform_random", "unstack", "where",
    "while",
]


def reference_graph(pg):
    """The reference's Graph of the port's `pg`, through the shared meta."""
    rg = r_artifact.graph_from_meta(p_artifact.graph_to_meta(pg))
    rg.weights = dict(pg.weights)
    rg.rebuild_links()
    return rg


def run_reference(case):
    """The reference's outputs of `case`, numpy, in the graph's order."""
    rg = reference_graph(arena.build_graph(case))
    weights = {k: jax.numpy.asarray(v) for k, v in R.stage_weights(rg).items()}
    want = R.build_callable(rg, platform="cpu")(weights, case.feed())
    return [np.asarray(jax.device_get(want[n])) for n in rg.outputs]


def run_both_case(case):
    """(reference outputs, port outputs), numpy, in the graph's order."""
    return run_reference(case), [t.numpy() for t in arena.run_case(case, CPU)]


def test_the_port_registers_the_reference_names():
    assert POPS.names() == ROPS.names()
    assert len(NEW_OPS) == 93 and set(NEW_OPS) <= set(POPS.names())
    for name in POPS.names():
        opdef = POPS.get(name)
        assert opdef.infer_shape is not None and "torch" in opdef.impls, name


def test_the_case_table_covers_every_name():
    assert sorted(CASES) == POPS.names()
    assert sorted(op_cases.cases(card=True)) == POPS.names()


@pytest.mark.parametrize("op_type", NEW_OPS)
def test_op_matches_reference(op_type):
    case = CASES[op_type]
    want, got = run_both_case(case)
    assert_same(want, got, exact=case.exact)


def _one_hot_np(ins):
    ids = ins["X"][0]
    return [(ids[..., None] == np.arange(5)).astype(np.float32)]


def _sequence_mask_np(ins):
    return [(np.arange(7) < ins["X"][0][..., None]).astype(np.float32)]


def _roll_np(ins):
    return [np.roll(ins["X"][0], (2, -1), axis=(1, 2))]


def _pad2d_np(ins):
    return [np.pad(ins["X"][0], ((0, 0), (1, 2), (2, 0), (0, 0)), constant_values=-0.5)]


ARENA = {  # an op against a plain numpy baseline, as the reference's arena tests do
    "one_hot": (arena.OpTestCase("one_hot", {"X": [np.array([[0, 4, 5, -1]], np.int32)]},
                                 {"depth": 5}), _one_hot_np),
    "sequence_mask": (arena.OpTestCase("sequence_mask", {"X": [np.array([0, 3, 7, 9], np.int32)]},
                                       {"maxlen": 7}, outs=(("Y", "FP32"),)), _sequence_mask_np),
    "roll": (arena.OpTestCase("roll", {"X": [CASES["roll"].inputs["X"][0]]},
                              {"shifts": [2, -1], "axis": [1, 2]}), _roll_np),
    "pad2d": (arena.OpTestCase("pad2d", {"X": [CASES["pad2d"].inputs["X"][0]]},
                               {"paddings": [1, 2, 2, 0], "pad_value": -0.5}), _pad2d_np),
}


@pytest.mark.parametrize("op_type", sorted(ARENA))
def test_run_arena_holds_every_tag_to_a_numpy_baseline(op_type):
    case, baseline = ARENA[op_type]
    out = arena.run_arena(case, baseline)
    assert set(out) == set(POPS.get(op_type).impls)


def test_run_arena_reports_a_mismatch():
    case, baseline = ARENA["roll"]
    with pytest.raises(AssertionError, match="roll kernel=torch"):
        arena.run_arena(case, lambda ins: [b + 1.0 for b in baseline(ins)])


# ---- the reference faults, corrected ------------------------------------------------

def test_max_pool_with_index_skips_padding():
    """A window that touches the padding takes its greatest element of the
    image, and its index lies in the image; the reference pools the
    zero-padded input, so 0 wins there and the index falls outside."""
    x = -np.arange(1, 17, dtype=np.float32).reshape(1, 4, 4, 1)
    case = arena.OpTestCase("max_pool2d_with_index", {"X": [x]},
                            {"ksize": [2, 2], "strides": [2, 2], "paddings": [1, 1]},
                            outs=(("Out", "FP32"), ("Mask", "INT32")))
    want, got = run_both_case(case)
    np.testing.assert_array_equal(got[0].reshape(-1),
                                  [-1, -2, -4, -5, -6, -8, -13, -14, -16])
    np.testing.assert_array_equal(got[1].reshape(-1), [0, 1, 3, 4, 5, 7, 12, 13, 15])
    np.testing.assert_array_equal(want[0].reshape(-1), [0, 0, 0, 0, -6, 0, 0, 0, 0])
    np.testing.assert_array_equal(want[1].reshape(-1), [-5, -3, -1, 3, 5, 8, 11, 17, 16])


def test_max_pool_with_index_equals_the_reference_without_padding():
    case = CASES["max_pool2d_with_index"]
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)


def test_roi_align_refuses_a_batch():
    """The reference pools every RoI from image 0 whatever N is; the port
    raises, with a message, rather than compute on the wrong image."""
    case = CASES["roi_align"]
    x = np.concatenate([case.inputs["X"][0], case.inputs["X"][0] + 1.0])
    two = arena.OpTestCase("roi_align", {"X": [x], "ROIs": case.inputs["ROIs"]}, case.attrs)
    with pytest.raises(ValueError, match="one image"):
        arena.run_case(two, CPU)
    np.testing.assert_array_equal(run_reference(two)[0],  # image 1 never read there
                                  run_reference(case)[0])


# ---- the traps ------------------------------------------------------------------------

def test_one_hot_out_of_range_gives_a_zero_row():
    ids = np.array([[-3, -1, 0, 2, 3, 4, 9]], np.int32)
    case = arena.OpTestCase("one_hot", {"X": [ids]}, {"depth": 4})
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)
    np.testing.assert_array_equal(got[0].sum(-1), [[0, 0, 1, 1, 1, 0, 0]])


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_fills_out_of_range_rows(dtype):
    x = (np.arange(15).reshape(5, 3) - 7).astype(dtype)
    idx = np.array([0, 4, 5, -1, -5, -6, 99], np.int32)
    case = arena.OpTestCase("gather", {"X": [x], "Index": [idx]},
                            outs=(("Out", "FP32" if dtype == np.float32 else "INT32"),))
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)
    bad = [2, 5, 6]
    if dtype == np.float32:
        assert np.isnan(got[0][bad]).all()
    else:
        assert (got[0][bad] == np.iinfo(np.int32).min).all()


@pytest.mark.parametrize("seed", [0, 7, 123456, -3])
@pytest.mark.parametrize("shape", [(5,), (3, 17), (2, 3, 129)])
def test_threefry_bits_equal_jax_random(seed, shape):
    """The port's threefry2x32 draws ``jax.random``'s bits: ``uniform`` bit
    for bit, ``normal`` (through erfinv) within rtol 1e-5 / atol 1e-6."""
    key = jax.random.PRNGKey(seed)
    bits = np.asarray(jax.random.bits(key, shape, dtype=np.uint32)).astype(np.int64)
    np.testing.assert_array_equal(longtail.random_bits(seed, shape, CPU).numpy(), bits)
    uni = np.asarray(jax.random.uniform(key, shape, minval=-2.0, maxval=3.0))
    np.testing.assert_array_equal(longtail.uniform_f32(seed, shape, -2.0, 3.0, CPU).numpy(), uni)
    nor = np.asarray(jax.random.normal(key, shape))
    np.testing.assert_allclose(longtail.normal_f32(seed, shape, CPU).numpy(), nor,
                               rtol=1e-5, atol=1e-6)


def test_random_ops_are_constants_of_the_graph():
    case = CASES["uniform_random"]
    g = arena.build_graph(case)
    fn = P.build_callable(g, device=CPU)
    a, b = fn({}, {}), fn({}, {})
    assert a[g.outputs[0]].data_ptr() == b[g.outputs[0]].data_ptr()


@pytest.mark.parametrize("attrs", [
    {"start": 0.0, "stop": 7.3, "num": 11}, {"start": 0.0, "stop": 1.0, "num": 256},
    {"start": 2.0, "stop": -1.0, "num": 2}, {"start": 5.0, "stop": 5.0, "num": 1}])
def test_linspace_from_zero_is_bit_exact(attrs):
    case = arena.OpTestCase("linspace", {}, attrs)
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)


def test_linspace_from_another_start_within_an_ulp_of_the_bound():
    """XLA on the CPU may contract a product of ``jnp.linspace`` into an
    FMA; the port's unfused form is a rounding away, within one ulp of the
    larger bound."""
    case = arena.OpTestCase("linspace", {}, {"start": -1.3, "stop": 7.9, "num": 40})
    want, got = run_both_case(case)
    assert np.abs(got[0] - want[0]).max() <= np.spacing(np.float32(7.9))


@pytest.mark.parametrize("attrs", [
    {"start": 0, "end": 10, "step": 1, "dtype": "int32"},
    {"start": 0.1, "end": 1.7, "step": 0.13}, {"start": 2.5, "end": -1.0, "step": -0.3}])
def test_range_equals_arange(attrs):
    prec = "INT32" if attrs.get("dtype") == "int32" else "FP32"
    case = arena.OpTestCase("range", {}, attrs, outs=(("Out", prec),))
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)


@pytest.mark.parametrize("op_type,dtype", [("cumsum", np.int32), ("scatter_nd_add", np.int32),
                                           ("scatter", np.int32)])
def test_integer_accumulation_is_exact(op_type, dtype):
    rng = np.random.default_rng(3)
    prec = (("Out", "INT32"),)
    if op_type == "cumsum":
        case = arena.OpTestCase("cumsum", {"X": [rng.integers(-9, 9, (3, 7)).astype(dtype)]},
                                {"axis": 1}, outs=prec)
    elif op_type == "scatter_nd_add":
        case = arena.OpTestCase("scatter_nd_add", {
            "X": [rng.integers(-9, 9, (4, 5, 2)).astype(dtype)],
            "Index": [rng.integers(-5, 6, (9, 2)).astype(np.int32)],
            "Updates": [rng.integers(-9, 9, (9, 2)).astype(dtype)]}, outs=prec)
    else:  # duplicates accumulate
        case = arena.OpTestCase("scatter", {
            "X": [rng.integers(-9, 9, (6, 2)).astype(dtype)],
            "Ids": [np.array([1, 1, 5, -1, 7, 0], np.int32)],
            "Updates": [rng.integers(-9, 9, (6, 2)).astype(dtype)]},
            {"overwrite": False}, outs=prec)
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)


def test_float_scatter_add_accumulates_duplicates():
    rng = np.random.default_rng(4)
    case = arena.OpTestCase("scatter", {
        "X": [rng.normal(size=(6, 3)).astype(np.float32)],
        "Ids": [np.array([2, 2, 2, 0, -2, 9], np.int32)],
        "Updates": [rng.normal(size=(6, 3)).astype(np.float32)]}, {"overwrite": False})
    want, got = run_both_case(case)
    assert_same(want, got, exact=False)


@pytest.mark.parametrize("mode", ["constant", "reflect", "edge"])
def test_pad2d_modes(mode):
    case = arena.OpTestCase("pad2d", {"X": [CASES["pad2d"].inputs["X"][0]]},
                            {"paddings": [2, 1, 0, 2], "mode": mode, "pad_value": -0.5})
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)


def test_argsort_is_stable_with_signed_zeros_and_nan():
    x = np.array([[0.0, -0.0, 1.0, np.nan, -1.0, 0.0, 1.0, -0.0]], np.float32)
    for descending in (False, True):
        case = arena.OpTestCase("argsort", {"X": [x]}, {"axis": -1, "descending": descending},
                                outs=(("Out", "FP32"), ("Indices", "INT64")))
        want, got = run_both_case(case)
        assert_same(want, got, exact=True)


def test_arg_min_takes_the_first_on_a_tie():
    x = np.array([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, -1.0, -1.0]], np.float32)
    case = arena.OpTestCase("arg_min", {"X": [x]}, {"axis": 1, "keepdims": True},
                            outs=(("Out", "INT64"),))
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)
    np.testing.assert_array_equal(got[0].reshape(-1), [1, 2])


def test_top_k_ties_in_lax_order():
    x = np.array([[1.0, 3.0, 3.0, -0.0, 0.0, 3.0, 0.0]], np.float32)
    case = arena.OpTestCase("top_k", {"X": [x]}, {"k": 6},
                            outs=(("Out", "FP32"), ("Indices", "INT64")))
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)


def test_matrix_nms_gaussian():
    case = CASES["matrix_nms"]
    g = arena.OpTestCase("matrix_nms", case.inputs, dict(case.attrs, use_gaussian=True,
                                                         gaussian_sigma=1.5, keep_top_k=-1),
                         exact=False)
    want, got = run_both_case(g)
    assert_same(want, got, exact=False)


@pytest.mark.parametrize("align", [True, False])
def test_grid_sampler_align_corners(align):
    case = CASES["grid_sampler"]
    g = arena.OpTestCase("grid_sampler", case.inputs, {"align_corners": align},
                         outs=case.outs, exact=False)
    want, got = run_both_case(g)
    assert_same(want, got, exact=False)


@pytest.mark.parametrize("ptype", ["MAX", "SUM", "LAST", "FIRST"])
def test_sequence_pool_types(ptype):
    case = arena.OpTestCase("sequence_pool", CASES["sequence_pool"].inputs,
                            {"pooltype": ptype}, exact=ptype != "SUM")
    want, got = run_both_case(case)
    assert_same(want, got, exact=case.exact)


def test_lstm_reversed():
    case = CASES["lstm"]
    g = arena.OpTestCase("lstm", case.inputs, {"is_reverse": True}, outs=case.outs,
                         exact=False)
    want, got = run_both_case(g)
    assert_same(want, got, exact=False)


def test_beam_search_keeps_finished_beams():
    """A beam whose last id is ``end_id`` is continued only by ``end_id``,
    at its own score."""
    rng = np.random.default_rng(5)
    probs = rng.uniform(0, 1, (2, 3, 7)).astype(np.float32)
    case = arena.OpTestCase("beam_search", {
        "pre_ids": [np.array([[1, 4, 2], [1, 1, 1]], np.int32)],
        "pre_scores": [np.array([[-0.1, -2.0, -0.5], [-0.3, -0.2, -0.9]], np.float32)],
        "scores": [probs]}, {"end_id": 1},
        outs=(("selected_ids", "INT32"), ("selected_scores", "FP32"), ("parent_idx", "INT32")),
        exact=False)
    want, got = run_both_case(case)
    assert_same(want, got, exact=False)
    np.testing.assert_array_equal(got[0][1], [1, 1, 1])
    np.testing.assert_array_equal(got[2][1], [1, 0, 2])


def test_conditional_block_false_passes_through():
    case = CASES["conditional_block"]
    g = arena.OpTestCase("conditional_block", {"Cond": [np.zeros((1,), np.bool_)],
                                               "Input": case.inputs["Input"]},
                         case.attrs)
    want, got = run_both_case(g)
    assert_same(want, got, exact=True)
    np.testing.assert_array_equal(got[0], case.inputs["Input"][0])


def test_calib_dequantizes_int8():
    x = np.random.default_rng(6).integers(-127, 128, (3, 4)).astype(np.int8)
    case = arena.OpTestCase("calib", {"X": [x]}, scales={"x0": 0.07})
    want, got = run_both_case(case)
    assert_same(want, got, exact=True)
