"""One sharded int8 inference step over n ranks: the multi-device dry run.

Counterpart of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:
45-80``): the flagship, MobileNetV1 INT8, at 32 px and 16 classes, PTQ'd
on two seeded batches, served by :class:`~.sharding.ShardedPredictor` at
``tp = 2`` where n is even (else 1) and ``dp = n / tp``, batch ``max(2·dp,
2)``; the output must have shape (batch, 16).  The reference runs a
virtual n-device CPU mesh in one process and strips its Pallas kernels
(``pallas=False``); here n gloo ranks are spawned (``distributed.spawn``)
and the graph keeps the port's kernel tags (on the CPU each kernel wrapper
runs its plain version).  The step runs compiled, as the reference's
``jax.jit`` does (the predictor's default; CUDA graphs cut at the
collectives on the card).

    python3 -m paddle_lite_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import numpy as np

from . import distributed

IMAGE_SIZE = 32
NUM_CLASSES = 16


def flagship_int8_graph(batch: int, image_size: int, num_classes: int = 1000,
                        device: str = "cuda"):
    """MobileNetV1 INT8 (the flagship), PTQ'd on two seeded batches on
    `device` (``"cuda"`` is cuda:0; the tests pass ``"cpu"``)."""
    from .. import QuantConfig
    from ..models import mobilenet_v1
    from ..tools.opt import optimize

    g = mobilenet_v1.build(batch=batch, image_size=image_size, num_classes=num_classes, seed=0)
    rng = np.random.default_rng(0)
    batches = [{"image": rng.normal(size=(batch, image_size, image_size, 3)).astype(np.float32)}
               for _ in range(2)]
    optimize(g, quant=QuantConfig(), calib_batches=batches, device=device)
    return g


def _step(graph, dp: int, tp: int, device: str) -> dict:
    """One rank's step: the compiled sharded predictor on the seeded feed."""
    from .sharding import MeshConfig, ShardedPredictor

    n = dp * tp
    pred = ShardedPredictor(graph, MeshConfig(data=dp, model=tp), devices=[device] * n,
                            backend="gloo")
    batch = graph.vars[graph.inputs[0]].shape[0]
    rng = np.random.default_rng(2)
    feed = {"image": rng.normal(size=(batch, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32)}
    out = pred.run(feed)[graph.outputs[0]]
    return {"shape": tuple(out.shape), "n_tp_ops": pred.n_tp_ops,
            "n_split_ops": pred.n_split_ops, "out": out.cpu().numpy()}


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = distributed.DEFAULT_TIMEOUT_S) -> dict:
    """Spawn `n_devices` gloo ranks on `device` (all on cuda:0 for
    ``"cuda"``, the default: gloo moves host copies, ``sharding``'s rule;
    ``"cpu"`` where the caller asks for it, as the tests do), run one
    sharded step and check the output's shape on every rank, and that the
    ranks agree.  Returns {"n_devices", "dp", "tp", "batch", "n_tp_ops",
    "n_split_ops", "shape"}."""
    tp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    dp = n_devices // tp
    batch = max(dp * 2, 2)
    g = flagship_int8_graph(batch, IMAGE_SIZE, NUM_CLASSES, device=device)
    res = distributed.spawn(_step, n_devices, (g, dp, tp, device), backend="gloo",
                            timeout_s=timeout_s, threads=1)
    for i, r in enumerate(res):
        if r["shape"] != (batch, NUM_CLASSES):
            raise RuntimeError(f"dry run: rank {i}'s output has shape {r['shape']}, "
                               f"expected {(batch, NUM_CLASSES)}")
        if not np.array_equal(r["out"], res[0]["out"]):
            raise RuntimeError(f"dry run: rank {i}'s output differs from rank 0's")
    return {"n_devices": n_devices, "dp": dp, "tp": tp, "batch": batch,
            "n_tp_ops": res[0]["n_tp_ops"], "n_split_ops": res[0]["n_split_ops"],
            "shape": list(res[0]["shape"])}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default="cuda", help="cpu, or cuda (every rank on cuda:0)")
    args = p.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n_devices, args.device)))


if __name__ == "__main__":
    main()
