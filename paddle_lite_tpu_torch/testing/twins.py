"""Torch twins of the zoo models — full-architecture, realistically
initialized counterparts used to prove the accuracy contract at scale.

Copy of ``paddle_lite_tpu/testing/twins.py`` (torch and numpy only).  The
twins are built on the CPU, as the reference builds them, so a seed gives
the same state dict in both packages.

No pretrained checkpoints are reachable in this environment (no network),
so the twins stand in for them: identical layer-for-layer architecture
(module registration order matches the zoo graphs' op creation order — the
importer's consumption contract) with *trained-looking* statistics:

- conv/fc weights: kaiming-normal (what trained CNN weight spectra resemble
  far more than the zoo's plain he-init on every layer);
- batch-norm: running_var log-normal around 1, running_mean ~ N(0, 0.3),
  gamma ~ N(1, 0.2), beta ~ N(0, 0.1) — matching the magnitude spread of
  published trained BN stats, which is what stresses conv_bn folding and
  PTQ calibration (identity stats would hide scale bugs).

Inputs for evaluation come from :func:`structured_images` — low-frequency
random fields with per-image brightness/contrast variation (photo-like
second-order statistics) rather than iid noise, so activation ranges vary
across layers the way natural images make them.
"""

from __future__ import annotations

import numpy as np


def _torch():
    import torch
    import torch.nn as nn

    return torch, nn


def realistic_init(model, seed: int = 0) -> None:
    """Trained-looking statistics (see module docstring). Deterministic:
    kaiming_/normal_ draw from the GLOBAL torch RNG, so it must be seeded
    too (a twin must build bit-identically for every (arch, seed))."""
    torch, nn = _torch()
    torch.manual_seed(seed)
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_normal_(m.weight, mode="fan_out",
                                    nonlinearity="relu")
            with torch.no_grad():
                m.weight.mul_(torch.empty(1).normal_(1.0, 0.1, generator=g)
                              .clamp(0.7, 1.3))
            if m.bias is not None:
                nn.init.normal_(m.bias, 0, 0.05)
        elif isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.normal_(1.0, 0.2, generator=g).clamp_(0.3, 2.0)
                m.bias.normal_(0.0, 0.1, generator=g)
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.log_normal_(0.0, 0.4, generator=g).clamp_(0.05, 5.0)
        elif isinstance(m, nn.Linear):
            nn.init.normal_(m.weight, 0, 0.02)
            if m.bias is not None:
                nn.init.normal_(m.bias, 0, 0.02)


def _calibrate_logit_scale(model, *, in_size: int, seed: int,
                           target_std: float = 4.0) -> None:
    """Rescale the final Linear so logits have trained-network spread
    (std ≈ 4 → confident softmax). A randomly-initialized head produces
    near-uniform probabilities, which makes top-1 agreement metrics pure
    noise; trained classifiers are confident, and the quantization-error
    question only makes sense in that regime."""
    torch, nn = _torch()
    linear = [m for m in model.modules() if isinstance(m, nn.Linear)][-1]
    gen = torch.Generator().manual_seed(seed + 12345)
    probe = torch.randn(8, 3, in_size, in_size, generator=gen)
    with torch.no_grad():
        std = float(model(probe).std())
        factor = target_std / max(std, 1e-6)
        linear.weight.mul_(factor)
        if linear.bias is not None:
            linear.bias.mul_(factor)


def torch_mobilenet_v1(num_classes: int = 1000, width_mult: float = 1.0,
                       seed: int = 0):
    torch, nn = _torch()

    def c(ch):
        return max(8, int(ch * width_mult))

    def cba(cin, cout, k, s, p, groups=1):
        return [nn.Conv2d(cin, cout, k, s, p, groups=groups, bias=False),
                nn.BatchNorm2d(cout), nn.ReLU()]

    blocks_cfg = [(1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
                  (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),
                  (2, 1024), (1, 1024)]
    layers = cba(3, c(32), 3, 2, 1)
    in_c = c(32)
    for s, out in blocks_cfg:
        layers += cba(in_c, in_c, 3, s, 1, groups=in_c)   # depthwise
        layers += cba(in_c, c(out), 1, 1, 0)              # pointwise
        in_c = c(out)
    layers += [nn.AdaptiveAvgPool2d(1), nn.Flatten(),
               nn.Linear(in_c, num_classes)]
    model = nn.Sequential(*layers)
    realistic_init(model, seed)
    model.eval()
    _calibrate_logit_scale(model, in_size=64, seed=seed)
    return model


def realistic_graph_init(graph, seed: int = 0) -> int:
    """Re-initialize a zoo graph's weights in place with trained-looking
    statistics — :func:`realistic_init` applied directly to graph weights
    for models without a torch twin (SSD, DBNet, CRNN).

    The zoo's plain he-init gives near-exchangeable output channels, so
    argmax/ranking metrics degenerate to near-tie coin flips that NO
    quantizer could preserve; trained networks have decisive margins
    (the MNv1/MNv3/R50 twins agree 100% after int8).  Returns the number
    of weight tensors re-drawn.
    """
    rng = np.random.default_rng(seed)
    n = 0
    bn_slots = {"Scale": (1.0, 0.2, 0.3, 2.0), "Bias": (0.0, 0.1, None, None),
                "Mean": (0.0, 0.3, None, None)}
    for op in graph.ops:
        t = op.op_type
        if t in ("conv2d", "depthwise_conv2d", "conv2d_transpose"):
            name = op.input("Filter")
            w = graph.weights.get(name)
            if w is None:
                continue
            kh, kw, ci, co = w.shape
            fan_out = kh * kw * (co if t != "depthwise_conv2d" else 1)
            gain = rng.normal(1.0, 0.1)
            graph.weights[name] = (
                rng.normal(0, np.sqrt(2.0 / max(fan_out, 1)), w.shape)
                * np.clip(gain, 0.7, 1.3)).astype(np.float32)
            n += 1
        elif t == "batch_norm":
            for slot, (mu, sig, lo, hi) in bn_slots.items():
                name = op.input(slot)
                if name not in graph.weights:
                    continue
                v = rng.normal(mu, sig, graph.weights[name].shape)
                if lo is not None:
                    v = np.clip(v, lo, hi)
                graph.weights[name] = v.astype(np.float32)
                n += 1
            vn = op.input("Variance")
            if vn in graph.weights:
                graph.weights[vn] = np.clip(
                    rng.lognormal(0.0, 0.4, graph.weights[vn].shape),
                    0.05, 5.0).astype(np.float32)
                n += 1
    return n


def torch_mobilenet_v3(num_classes: int = 1000, seed: int = 0):
    """Twin of models/mobilenet_v3.py (MobileNetV3-Large). Registration
    order matches the zoo's op creation order exactly: per block
    expand conv+bn → depthwise conv+bn → SE (two biased 1x1 convs) →
    project conv+bn; SE uses paddle's hard_sigmoid (slope 0.2, offset 0.5),
    not torch's Hardsigmoid (slope 1/6)."""
    torch, nn = _torch()

    # (kernel, exp_size, out_c, use_se, act, stride) — keep in sync with
    # models/mobilenet_v3._BLOCKS
    blocks_cfg = [
        (3, 16, 16, False, "relu", 1),
        (3, 64, 24, False, "relu", 2),
        (3, 72, 24, False, "relu", 1),
        (5, 72, 40, True, "relu", 2),
        (5, 120, 40, True, "relu", 1),
        (5, 120, 40, True, "relu", 1),
        (3, 240, 80, False, "hswish", 2),
        (3, 200, 80, False, "hswish", 1),
        (3, 184, 80, False, "hswish", 1),
        (3, 184, 80, False, "hswish", 1),
        (3, 480, 112, True, "hswish", 1),
        (3, 672, 112, True, "hswish", 1),
        (5, 672, 160, True, "hswish", 2),
        (5, 960, 160, True, "hswish", 1),
        (5, 960, 160, True, "hswish", 1),
    ]

    class SE(nn.Module):
        def __init__(self, c, ratio=4):
            super().__init__()
            mid = max(c // ratio, 8)
            self.fc1 = nn.Conv2d(c, mid, 1)       # bias=True, like the zoo
            self.fc2 = nn.Conv2d(mid, c, 1)

        def forward(self, x):
            s = x.mean((2, 3), keepdim=True)
            s = torch.relu(self.fc1(s))
            s = torch.clamp(0.2 * self.fc2(s) + 0.5, 0.0, 1.0)
            return x * s

    class Block(nn.Module):
        def __init__(self, cin, k, exp, out_c, use_se, act, stride):
            super().__init__()
            self.use_res = stride == 1 and cin == out_c
            self.act = nn.Hardswish() if act == "hswish" else nn.ReLU()
            if exp != cin:
                self.expand = nn.Conv2d(cin, exp, 1, bias=False)
                self.expand_bn = nn.BatchNorm2d(exp)
            else:
                self.expand = None
            self.dw = nn.Conv2d(exp, exp, k, stride, k // 2, groups=exp,
                                bias=False)
            self.dw_bn = nn.BatchNorm2d(exp)
            self.se = SE(exp) if use_se else None
            self.project = nn.Conv2d(exp, out_c, 1, bias=False)
            self.project_bn = nn.BatchNorm2d(out_c)

        def forward(self, x):
            y = x
            if self.expand is not None:
                y = self.act(self.expand_bn(self.expand(y)))
            y = self.act(self.dw_bn(self.dw(y)))
            if self.se is not None:
                y = self.se(y)
            y = self.project_bn(self.project(y))
            return x + y if self.use_res else y

    class MNv3(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = nn.Conv2d(3, 16, 3, 2, 1, bias=False)
            self.stem_bn = nn.BatchNorm2d(16)
            self.hs = nn.Hardswish()
            blocks = []
            cin = 16
            for k, exp, out_c, use_se, act, stride in blocks_cfg:
                blocks.append(Block(cin, k, exp, out_c, use_se, act, stride))
                cin = out_c
            self.blocks = nn.Sequential(*blocks)
            self.head_conv = nn.Conv2d(cin, 960, 1, bias=False)
            self.head_bn = nn.BatchNorm2d(960)
            self.pre_fc = nn.Conv2d(960, 1280, 1)  # bias=True, like the zoo
            self.fc = nn.Linear(1280, num_classes)

        def forward(self, x):
            x = self.hs(self.stem_bn(self.stem(x)))
            x = self.blocks(x)
            x = self.hs(self.head_bn(self.head_conv(x)))
            x = x.mean((2, 3), keepdim=True)
            x = self.hs(self.pre_fc(x))
            return self.fc(x.flatten(1))

    model = MNv3()
    realistic_init(model, seed)
    model.eval()
    _calibrate_logit_scale(model, in_size=64, seed=seed)
    return model


def torch_resnet50(num_classes: int = 1000, seed: int = 0):
    """Matches models/resnet.py op-creation order: in projecting blocks the
    downsample conv+bn are registered BEFORE the main-path convs."""
    torch, nn = _torch()

    class Bottleneck(nn.Module):
        def __init__(self, cin, mid, cout, stride, project):
            super().__init__()
            if project:  # registration order == zoo creation order
                self.down_conv = nn.Conv2d(cin, cout, 1, stride, bias=False)
                self.down_bn = nn.BatchNorm2d(cout)
            else:
                self.down_conv = None
            self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
            self.bn1 = nn.BatchNorm2d(mid)
            self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False)
            self.bn2 = nn.BatchNorm2d(mid)
            self.conv3 = nn.Conv2d(mid, cout, 1, bias=False)
            self.bn3 = nn.BatchNorm2d(cout)
            self.relu = nn.ReLU()

        def forward(self, x):
            sc = x if self.down_conv is None else self.down_bn(self.down_conv(x))
            y = self.relu(self.bn1(self.conv1(x)))
            y = self.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
            return self.relu(y + sc)

    class ResNet50(nn.Module):
        def __init__(self):
            super().__init__()
            self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
            self.stem_bn = nn.BatchNorm2d(64)
            self.relu = nn.ReLU()
            self.maxpool = nn.MaxPool2d(3, 2, 1)
            stages = [(3, 64, 256, 1), (4, 128, 512, 2),
                      (6, 256, 1024, 2), (3, 512, 2048, 2)]
            blocks = []
            cin = 64
            for n, mid, cout, stride in stages:
                for i in range(n):
                    blocks.append(Bottleneck(
                        cin, mid, cout,
                        stride if i == 0 else 1, project=(i == 0)))
                    cin = cout
            self.blocks = nn.Sequential(*blocks)
            self.pool = nn.AdaptiveAvgPool2d(1)
            self.fc = nn.Linear(2048, num_classes)

        def forward(self, x):
            x = self.maxpool(self.relu(self.stem_bn(self.stem_conv(x))))
            x = self.blocks(x)
            x = self.pool(x).flatten(1)
            return self.fc(x)

    model = ResNet50()
    realistic_init(model, seed)
    model.eval()
    _calibrate_logit_scale(model, in_size=64, seed=seed)
    return model


def structured_images(n: int, size: int, *, seed: int = 0,
                      batch: int = 50):
    """Photo-like random fields: sum of low-frequency cosine modes +
    mild white noise, per-image brightness/contrast jitter, channel
    correlation. NCHW float32, roughly imagenet-normalized range."""
    rng = np.random.default_rng(seed)
    done = 0
    while done < n:
        bsz = min(batch, n - done)
        yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                             indexing="ij")
        imgs = np.zeros((bsz, 3, size, size), np.float32)
        for i in range(bsz):
            base = np.zeros((size, size), np.float32)
            for _ in range(6):  # low-frequency modes
                fy, fx = rng.uniform(0.5, 6, 2)
                ph = rng.uniform(0, 2 * np.pi, 2)
                base += rng.normal(0, 1) * np.cos(
                    2 * np.pi * (fy * yy + ph[0])) * np.cos(
                    2 * np.pi * (fx * xx + ph[1])).astype(np.float32)
            base /= max(np.abs(base).max(), 1e-6)
            contrast = rng.uniform(0.4, 1.4)
            bright = rng.normal(0, 0.4)
            for ch in range(3):
                chan = (contrast * base * rng.uniform(0.6, 1.0)
                        + bright + rng.normal(0, 0.15)
                        + 0.1 * rng.standard_normal((size, size)))
                imgs[i, ch] = chan
        done += bsz
        yield imgs
