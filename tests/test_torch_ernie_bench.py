"""ERNIE-tiny as the benchmark runs it (``benchmark/configs/ernie_tiny_int8.json``:
the published ReLU FFN), at a small size on the CPU: hidden 64, 4 heads,
FFN 256, 2 layers, vocabulary 97, 16 tokens, batch 2, 16 classes.

The benchmark's plain reference (``benchmark/reference/tref.py`` over
``ernie_tiny_int8.py``) is held against the port's predictor on the token
family's seeded weights and ids:

- float32: the reference's float pass against the unquantized predictor,
  probabilities within ``FLOAT_ATOL`` = 1e-5: both sides are float32 with
  TF32 off, summed in another order (the port's fc / matmul / layer_norm
  against ``torch.nn.functional``), two layers deep and through a softmax
  (measured 4.2e-7);
- int8: the reference at 8 bits against the int8 predictor through the
  family's ``compare``, inside the cell's limits
  (``benchmark/limits/ernie_tiny_b32_s128_offline.json``); the int4
  control (the reference at 4 bits in the program's place) fails them.

``hidden_act="relu"`` makes FFN1 one ``"cuda"`` int8 ``fc`` with the ReLU
and the requant in its epilogue; the default graph is the JAX package's,
op for op (``tests/test_torch_ernie.py`` holds it to the package)."""

import numpy as np
import pytest
import torch

from benchmark.cell import ROOT, generator, load_json
from benchmark.families import token_int8
from paddle_lite_tpu_torch.core.types import Precision
from paddle_lite_tpu_torch.models import ernie_tiny
from paddle_lite_tpu_torch.runtime.predictor import create_predictor

CPU = torch.device("cpu")
SEEDS = (2**31 + 5, 12345)
BATCH = 2
FLOAT_ATOL = 1e-5
SMALL = dict(hidden_size=64, num_attention_heads=4, intermediate_size=256,
             num_hidden_layers=2, vocab_size=97, seq_len=16, num_classes=16,
             calib_sequences=4, reference_block=2)
LIMITS = load_json(ROOT / "benchmark" / "limits" / "ernie_tiny_b32_s128_offline.json")
GRAPH_KW = dict(batch=2, seq_len=16, vocab_size=97, hidden=64, n_layers=2, n_heads=4,
                ffn_dim=256, num_classes=16)


def small_cfg() -> dict:
    cfg = load_json(ROOT / "benchmark" / "configs" / "ernie_tiny_int8.json")
    cfg.update(SMALL)
    cfg["inputs"] = dict(cfg["inputs"], min_sentence=3)
    return cfg


def made_and_ids(seed: int):
    cfg = small_cfg()
    gen = generator(seed, CPU)
    made = token_int8.make(cfg, gen, CPU)
    return cfg, made, token_int8.inputs(cfg, gen, 2 * BATCH, CPU)


@pytest.mark.parametrize("seed", SEEDS)
def test_float_reference_against_unquantized_predictor(seed):
    cfg, made, x = made_and_ids(seed)
    sizes = {arg: cfg[key] for arg, key in cfg["program"]["args"].items()}
    g = ernie_tiny.build(batch=BATCH, **sizes)
    token_int8.install(g, made.spec, made.raw)
    pred = create_predictor(g, device=CPU)
    ref = token_int8.Reference(cfg, made, CPU)
    for i in range(0, len(x), BATCH):
        got = token_int8.answer(pred, pred.run(token_int8.feed(pred, x[i:i + BATCH])))
        want = ref.ref.float(x[i:i + BATCH])
        assert got.dtype == torch.float32 and got.shape == (BATCH, cfg["num_classes"])
        np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("seed", SEEDS)
def test_int8_reference_within_limits_and_int4_control_not(seed):
    cfg, made, x = made_and_ids(seed)
    pred = token_int8.build(cfg, made, BATCH, CPU)
    ref = token_int8.Reference(cfg, made, CPU)
    pool = torch.cat([ref(x[i:i + BATCH]) for i in range(0, len(x), BATCH)])
    low = torch.cat([ref(x[i:i + BATCH], low=True) for i in range(0, len(x), BATCH)])
    control = {}
    for i in range(0, len(x), BATCH):
        idx = torch.arange(i, i + BATCH)
        got = token_int8.answer(pred, pred.run(token_int8.feed(pred, x[i:i + BATCH])))
        for k, v in token_int8.compare(got, pool, idx).items():
            assert float(v.max()) <= LIMITS[k], (k, v)
        for k, v in token_int8.compare(low[idx], pool, idx).items():
            control[k] = max(control.get(k, 0.0), float(v.max()))
    assert any(control[k] > LIMITS[k] for k in LIMITS), control


def _ops(g):
    return [(op.op_type, sorted(op.attrs)) for op in g.ops]


def test_relu_is_fused_into_ffn1():
    cfg, made, _ = made_and_ids(SEEDS[0])
    g = token_int8.build(cfg, made, BATCH, CPU).graph
    ffn1 = [op for op in g.ops if op.op_type == "fc" and op.input("W").endswith("ffn1.w")]
    assert len(ffn1) == cfg["num_hidden_layers"]
    for op in ffn1:
        assert op.attrs["kernel"] == "cuda" and op.attrs["enable_int8"]
        assert op.attrs["fuse_act"] == "relu" and op.attrs["out_scale"] > 0
        assert g.vars[op.output("Out")].precision == Precision.INT8
    assert not [op for op in g.ops if op.op_type in ("relu", "gelu")]
    fcs = [op for op in g.ops if op.op_type == "fc"]
    # QKV, out, FFN1, FFN2 a layer; the pooler and the 16-wide classifier
    assert len(fcs) == 4 * cfg["num_hidden_layers"] + 2
    assert all(op.attrs["kernel"] == "cuda" for op in fcs)


def test_default_graph_unchanged_by_the_option():
    default, gelu = ernie_tiny.build(**GRAPH_KW), ernie_tiny.build(**GRAPH_KW, hidden_act="gelu")
    relu = ernie_tiny.build(**GRAPH_KW, hidden_act="relu")
    assert _ops(default) == _ops(gelu)
    assert [op.op_type for op in default.ops if op.op_type in ("gelu", "relu")] == ["gelu"] * 2
    swapped = [("relu" if t == "gelu" else t) for t, _ in _ops(default)]
    assert [t for t, _ in _ops(relu)] == swapped
    assert all(np.array_equal(default.weights[k], relu.weights[k]) for k in default.weights)
    with pytest.raises(ValueError, match="hidden_act"):
        ernie_tiny.build(**GRAPH_KW, hidden_act="swish")
