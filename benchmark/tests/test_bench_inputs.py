"""Weights, images and the Poisson schedule are reproduced exactly from a
seed, and differ between seeds."""

import numpy as np
import torch

from benchmark import traffic
from benchmark.cell import ROOT, generator, load_json
from benchmark.families import cnn_int8

CPU = torch.device("cpu")
SEEDS = (5, 2**31 + 11)
MIX = {"kind": "poisson", "rate_per_s": 500.0, "pool_images": 256}


def test_schedule_repeats():
    for seed in SEEDS:
        a, b = traffic.poisson_schedule(MIX, 3.0, seed), traffic.poisson_schedule(MIX, 3.0, seed)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        assert np.all(np.diff(a[0]) > 0) and a[0][-1] < 3.0
        assert 1490 <= len(a[0]) <= 1500
        assert a[1].min() >= 0 and a[1].max() < 256
    a, c = traffic.poisson_schedule(MIX, 3.0, SEEDS[1]), traffic.poisson_schedule(MIX, 3.0, SEEDS[1] + 1)
    assert not np.array_equal(a[0][:100], c[0][:100]) and not np.array_equal(a[1][:100], c[1][:100])
    # the same gaps in another order
    n = min(len(a[0]), len(c[0]))
    ga, gc = np.sort(np.diff(a[0][:n])), np.sort(np.diff(c[0][:n]))
    assert np.median(ga) == np.median(gc) or abs(np.median(ga) / np.median(gc) - 1) < 0.02


def test_pools_and_weights_repeat():
    cfg = load_json(ROOT / "benchmark" / "configs" / "mobilenet_v1_int8.json")
    cfg.update(image_size=32, calib_images=4, reference_block=4)

    def draw(seed):
        g = generator(seed, CPU)
        made = cnn_int8.make(cfg, g, CPU)
        return made, cnn_int8.inputs(cfg, g, 4, CPU)

    for seed in SEEDS:
        (m1, x1), (m2, x2) = draw(seed), draw(seed)
        assert all(np.array_equal(m1.raw[k], m2.raw[k]) for k in m1.raw)
        assert np.array_equal(m1.calib, m2.calib) and torch.equal(x1, x2)
    (m1, x1), (m2, x2) = draw(SEEDS[0]), draw(SEEDS[0] + 1)
    assert not torch.equal(x1, x2) and not np.array_equal(m1.raw["fc.w"], m2.raw["fc.w"])
    assert m1.raw["stem.w"].shape == (3, 3, 3, 32) and x1.shape == (4, 32, 32, 3)
    # the batch norms were set from the calibration images
    assert m1.raw["stem.bn.var"].min() > 0 and not np.allclose(m1.raw["stem.bn.var"], 1.0)
