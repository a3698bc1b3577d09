"""The check on the CPU at a small size (the published widths, 64 px, two
images a batch): each reference agrees with the program; the control (the
reference at 4 bits in the program's place) and each fault the cells can
have, planted under the timed path, come out as not correct.

The harness's look for a card is skipped; the rest of a run is driven as
``benchmark.run`` drives it."""

import pytest
import torch

from benchmark.cell import ROOT, Cell, Run, load_json

CPU = torch.device("cpu")
SEED = 2**31 + 99
WORKLOADS = ["mnv1_b64_offline", "r50_b32_offline"]


def small(workload: str = None, config: str = None, mix: str = None) -> Cell:
    cell = Cell(ROOT, workload, config, mix)
    cell.cfg["image_size"] = 64
    cell.cfg["calib_images"] = 4
    cell.cfg["reference_block"] = 4
    if cell.mix["kind"] == "closed":
        cell.mix.update(batch=2, pool_batches=2, checked_calls=4)
    else:
        cell.mix.update(rate_per_s=40.0, pool_images=8, batcher={"buckets": [1, 2, 4]})
    return cell


def kept_for_later(mix: str) -> Cell:
    """A mix no cell uses yet (``PERF.md``, Open questions): numpy batches
    from host memory over MobileNetV1, or served single images over
    ResNet-50, held to the limits of the same model's offline cell."""
    config, limits = (("mobilenet_v1_int8", "mnv1_b64_offline") if mix == "closed_b64_host"
                      else ("resnet50_int8", "r50_b32_offline"))
    cell = small(config=config, mix=mix)
    cell.limits = load_json(ROOT / "benchmark" / "limits" / f"{limits}.json")
    return cell


LATER = ["closed_b64_host", "poisson_800"]


def cell_of(name: str) -> Cell:
    return kept_for_later(name) if name in LATER else small(name)


def run(cell: Cell, plant=None) -> Run:
    r = Run(cell, SEED, 1.0, False, CPU, 0.0)
    r.setup()
    if plant is not None:
        for p in ([r.pred] if hasattr(r, "pred") else list(r.preds.values())):
            orig = p.run
            p.run = (lambda orig: lambda inputs: plant(r, inputs, orig(inputs)))(orig)
    r.window()
    r.free_program()
    return r


def correct(r: Run) -> bool:
    return r.result(r.check())["correct"]


def _with(r: Run, out: dict, y: torch.Tensor) -> dict:
    return {r.graph.outputs[0]: y}


def int4_in_place(r: Run, inputs, out):
    """The control: the plain reference at 4 bits answers instead."""
    ref = r.cell.family.Reference(r.cell.cfg, r.made, CPU)
    x = torch.as_tensor(inputs[r.graph.inputs[0]])
    return _with(r, out, ref(x, low=True).to(torch.float32))


def half_left_out(r: Run, inputs, out):
    y = out[r.graph.outputs[0]].clone()
    y[y.shape[0] // 2:] = 0
    return _with(r, out, y)


def answer_altered(r: Run, inputs, out):
    """The first answer of each call altered: its classes rolled by one."""
    y = out[r.graph.outputs[0]].clone()
    y[0] = torch.roll(y[0], 1)
    return _with(r, out, y)


def rows_swapped(r: Run, inputs, out):
    """A call's first two answers exchanged (rows sliced wrongly)."""
    y = out[r.graph.outputs[0]].clone()
    if len(y) > 1:
        y[[0, 1]] = y[[1, 0]]
    return _with(r, out, y)


class Stale:
    """Each call answered with the previous call's answers (a static input
    buffer not refreshed), or with `rows` of them (`half`: the second half
    of the rows left over from the last replay)."""

    def __init__(self, half: bool = False):
        self.half, self.last = half, None
        self.__name__ = "half_stale" if half else "stale_input"

    def __call__(self, r: Run, inputs, out):
        y = out[r.graph.outputs[0]].clone()
        prev, self.last = self.last, y.clone()
        if prev is not None and len(prev) == len(y):
            h = len(y) // 2 if self.half else 0
            y[h:] = prev[h:]
        return _with(r, out, y)


@pytest.mark.parametrize("workload", WORKLOADS + LATER)
def test_reference_agrees(workload):
    r = run(cell_of(workload))
    check = r.check()
    assert check["unanswered"]["value"] == 0
    assert check["own_vs_other"]["value"] < 0.5
    assert correct(r)


@pytest.mark.parametrize("workload", ["mnv1_b64_offline", "poisson_800"])
@pytest.mark.parametrize("plant", [int4_in_place, half_left_out, answer_altered])
def test_faults_fail(workload, plant):
    r = run(cell_of(workload), plant)
    line = r.result(r.check())
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("workload", ["mnv1_b64_offline", "r50_b32_offline"])
@pytest.mark.parametrize("plant", [rows_swapped, Stale(), Stale(half=True)],
                         ids=["rows_swapped", "stale_input", "half_stale"])
def test_answers_of_other_inputs_fail(workload, plant):
    """An answer that belongs to another input fails the check, though the
    inputs' answers lie closer together than the control's."""
    if isinstance(plant, Stale):
        plant.last = None
    r = run(small(workload), plant)
    line = r.result(r.check())
    assert not line["correct"], line["check"]
    assert line["check"]["own_vs_other"]["value"] > line["check"]["own_vs_other"]["limit"]
