"""The token family on the CPU at a small size (hidden 64, 4 heads, FFN 256,
2 layers, vocabulary 97, 16 tokens, two sequences a batch): the same seed
gives the same ids, the ids are laid out as the family states, the program
agrees with the reference through a whole run, and the faults a closed loop
can have, planted under the timed path, come out as not correct.

The harness's look for a card is skipped; the rest of a run is driven as
``benchmark.run`` drives it."""

import pytest
import torch

from benchmark.cell import ROOT, Cell, Run, generator
from benchmark.families import token_int8

CPU = torch.device("cpu")
SEED = 2**31 + 77
WORKLOAD = "ernie_tiny_b32_s128_offline"
SMALL = dict(hidden_size=64, num_attention_heads=4, intermediate_size=256,
             num_hidden_layers=2, vocab_size=97, seq_len=16, num_classes=16,
             calib_sequences=4, reference_block=2)


def small() -> Cell:
    cell = Cell(ROOT, WORKLOAD)
    cell.cfg.update(SMALL)
    cell.cfg["inputs"] = dict(cell.cfg["inputs"], min_sentence=3)
    cell.mix.update(batch=2, pool_batches=2, checked_calls=4)
    return cell


def test_same_seed_same_ids():
    cfg = small().cfg
    a = token_int8.inputs(cfg, generator(SEED, CPU), 8, CPU)
    b = token_int8.inputs(cfg, generator(SEED, CPU), 8, CPU)
    c = token_int8.inputs(cfg, generator(SEED + 1, CPU), 8, CPU)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.int32 and a.shape == (8, 2, 16)


def test_ids_laid_out():
    cfg = small().cfg
    x = token_int8.inputs(cfg, generator(SEED, CPU), 64, CPU)
    tok, seg = x[:, 0], x[:, 1]
    cls, sep = cfg["special_ids"]["cls"], cfg["special_ids"]["sep"]
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg["vocab_size"]
    assert bool((tok[:, 0] == cls).all()) and bool((tok[:, -1] == sep).all())
    for t, s in zip(tok, seg):
        seps = (t == sep).nonzero().flatten().tolist()
        assert len(seps) == 2 and seps[1] == len(t) - 1
        # [CLS] s1 [SEP] | s2 [SEP], each sentence at least min_sentence long
        assert s.tolist() == [0] * (seps[0] + 1) + [1] * (len(t) - seps[0] - 1)
        assert seps[0] - 1 >= 3 and len(t) - seps[0] - 2 >= 3
        words = torch.cat([t[1:seps[0]], t[seps[0] + 1:-1]])
        assert int(words.min()) >= cfg["inputs"]["first_word_id"]
    # Zipf: the most frequent word is the first ordinary id
    words = tok[:, 1:-1][tok[:, 1:-1] != sep]
    assert int(torch.bincount(words).argmax()) == cfg["inputs"]["first_word_id"]


def run(cell: Cell, plant=None) -> Run:
    r = Run(cell, SEED, 1.0, False, CPU, 0.0)
    r.setup()
    if plant is not None:
        orig = r.pred.run
        r.pred.run = lambda inputs: plant(r, orig(inputs))
    r.window()
    r.free_program()
    return r


def _with(r: Run, y: torch.Tensor) -> dict:
    return {r.graph.outputs[0]: y}


def rows_swapped(r: Run, out):
    y = out[r.graph.outputs[0]].clone()
    y[[0, 1]] = y[[1, 0]]
    return _with(r, y)


class Stale:
    """Each call answered with the previous call's answers, or (`half`)
    the second half of its rows left from them."""

    def __init__(self, half: bool = False):
        self.half, self.last = half, None

    def __call__(self, r: Run, out):
        y = out[r.graph.outputs[0]].clone()
        prev, self.last = self.last, y.clone()
        if prev is not None:
            h = len(y) // 2 if self.half else 0
            y[h:] = prev[h:]
        return _with(r, y)


def test_reference_agrees():
    r = run(small())
    line = r.result(r.check())
    assert line["correct"], line["check"]
    assert line["check"]["own_vs_other"]["value"] < 0.1


@pytest.mark.parametrize("plant", [rows_swapped, Stale(), Stale(half=True)],
                         ids=["rows_swapped", "stale_input", "half_stale"])
def test_answers_of_other_inputs_fail(plant):
    if isinstance(plant, Stale):
        plant.last = None
    r = run(small(), plant)
    line = r.result(r.check())
    assert not line["correct"], line["check"]
    assert line["check"]["own_vs_other"]["value"] > line["check"]["own_vs_other"]["limit"]


def test_attention_reader():
    """``kernels.attention_ms`` sums cuBLAS GEMM and softmax kernels a call,
    leaves the port's int8 GEMM out, reads nothing without a float matmul
    and raises when the trace matches none."""
    from types import SimpleNamespace

    from benchmark.cell import load_reader

    read = load_reader(ROOT, "kernels.attention_ms")
    kernels = {"sm80_xmma_gemm_f32f32_f32f32_f32_nn_n": [6, 0.003],
               "void (anonymous namespace)::softmax_warp_forward<float>": [4, 0.001],
               "void (anonymous namespace)::int8_gemm_kernel<256, 2, 0, false>": [14, 0.02],
               "void at::native::elementwise_kernel<add>": [38, 0.005]}
    ops = [SimpleNamespace(op_type="matmul", attrs={}),
           SimpleNamespace(op_type="fc", attrs={"enable_int8": True})]
    r = SimpleNamespace(trace={"calls": 2, "kernels": kernels}, graph=SimpleNamespace(ops=ops))
    assert read(r) == pytest.approx(1e3 * 0.004 / 2)
    assert read(SimpleNamespace(trace=r.trace, graph=SimpleNamespace(ops=ops[1:]))) is None
    assert read(SimpleNamespace(trace=None, graph=r.graph)) is None
    with pytest.raises(RuntimeError, match="float matmuls"):
        read(SimpleNamespace(trace={"calls": 2, "kernels": {}}, graph=r.graph))
