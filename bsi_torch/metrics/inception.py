"""InceptionV3, the FID variant, as an ``nn.Module``.

Counterpart of ``bsi_tpu/metrics/inception.py``: the network of
pytorch-fid's ``pt_inception-2015-12-05`` weights (what torchmetrics'
``NoTrainInceptionV3`` loads), with its two deviations from torchvision's
InceptionV3: the 3x3 average pools do not count the padding
(``count_include_pad=False``), and Mixed_7c's pool branch takes the
**max**. The submodules carry pt_inception's names (``Conv2d_1a_3x3.conv``,
``.bn``, ``Mixed_5b.branch1x1``, ...), so the official state dict loads
with ``load_state_dict`` once its ``fc`` head is dropped. Each BatchNorm
(eps 1e-3) runs in inference mode after its convolution: the affine that
the JAX package folds into a scale and a shift.

Input: uint8 NHWC images. The embed function divides by 255, resizes to
299x299 bilinearly with half-pixel centres and no antialiasing
(``F.interpolate(align_corners=False)``), maps to [-1, 1], and returns the
2048 features averaged over height and width.

Weights: a ``.pth`` state dict of pt_inception, or the JAX package's
converted HWIO ``.npz``; :func:`default_weights_path` finds either where
the JAX package looks (``$BSI_TPU_INCEPTION_WEIGHTS``, then
``data/pt_inception*``), so one file serves both packages.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bsi_torch.core.common import resolve_device

BN_EPS = 1e-3


def _conv_specs() -> list[tuple[str, int, int, tuple[int, int]]]:
    """(name, c_in, c_out, (kh, kw)) for every BasicConv2d in the network."""
    specs: list[tuple[str, int, int, tuple[int, int]]] = []

    def c(name, cin, cout, k):
        specs.append((name, cin, cout, (k, k) if isinstance(k, int) else k))

    c("Conv2d_1a_3x3", 3, 32, 3)
    c("Conv2d_2a_3x3", 32, 32, 3)
    c("Conv2d_2b_3x3", 32, 64, 3)
    c("Conv2d_3b_1x1", 64, 80, 1)
    c("Conv2d_4a_3x3", 80, 192, 3)

    def block_a(n, cin, pool):
        c(f"{n}.branch1x1", cin, 64, 1)
        c(f"{n}.branch5x5_1", cin, 48, 1)
        c(f"{n}.branch5x5_2", 48, 64, 5)
        c(f"{n}.branch3x3dbl_1", cin, 64, 1)
        c(f"{n}.branch3x3dbl_2", 64, 96, 3)
        c(f"{n}.branch3x3dbl_3", 96, 96, 3)
        c(f"{n}.branch_pool", cin, pool, 1)

    def block_b(n, cin):
        c(f"{n}.branch3x3", cin, 384, 3)
        c(f"{n}.branch3x3dbl_1", cin, 64, 1)
        c(f"{n}.branch3x3dbl_2", 64, 96, 3)
        c(f"{n}.branch3x3dbl_3", 96, 96, 3)

    def block_c(n, cin, c7):
        c(f"{n}.branch1x1", cin, 192, 1)
        c(f"{n}.branch7x7_1", cin, c7, 1)
        c(f"{n}.branch7x7_2", c7, c7, (1, 7))
        c(f"{n}.branch7x7_3", c7, 192, (7, 1))
        c(f"{n}.branch7x7dbl_1", cin, c7, 1)
        c(f"{n}.branch7x7dbl_2", c7, c7, (7, 1))
        c(f"{n}.branch7x7dbl_3", c7, c7, (1, 7))
        c(f"{n}.branch7x7dbl_4", c7, c7, (7, 1))
        c(f"{n}.branch7x7dbl_5", c7, 192, (1, 7))
        c(f"{n}.branch_pool", cin, 192, 1)

    def block_d(n, cin):
        c(f"{n}.branch3x3_1", cin, 192, 1)
        c(f"{n}.branch3x3_2", 192, 320, 3)
        c(f"{n}.branch7x7x3_1", cin, 192, 1)
        c(f"{n}.branch7x7x3_2", 192, 192, (1, 7))
        c(f"{n}.branch7x7x3_3", 192, 192, (7, 1))
        c(f"{n}.branch7x7x3_4", 192, 192, 3)

    def block_e(n, cin):
        c(f"{n}.branch1x1", cin, 320, 1)
        c(f"{n}.branch3x3_1", cin, 384, 1)
        c(f"{n}.branch3x3_2a", 384, 384, (1, 3))
        c(f"{n}.branch3x3_2b", 384, 384, (3, 1))
        c(f"{n}.branch3x3dbl_1", cin, 448, 1)
        c(f"{n}.branch3x3dbl_2", 448, 384, 3)
        c(f"{n}.branch3x3dbl_3a", 384, 384, (1, 3))
        c(f"{n}.branch3x3dbl_3b", 384, 384, (3, 1))
        c(f"{n}.branch_pool", cin, 192, 1)

    block_a("Mixed_5b", 192, 32)
    block_a("Mixed_5c", 256, 64)
    block_a("Mixed_5d", 288, 64)
    block_b("Mixed_6a", 288)
    block_c("Mixed_6b", 768, 128)
    block_c("Mixed_6c", 768, 160)
    block_c("Mixed_6d", 768, 160)
    block_c("Mixed_6e", 768, 192)
    block_d("Mixed_7a", 768)
    block_e("Mixed_7b", 1280)
    block_e("Mixed_7c", 2048)
    return specs


_SPECS = {name: (cin, cout, k) for name, cin, cout, k in _conv_specs()}


class BasicConv2d(nn.Module):
    """Convolution without bias, inference BatchNorm (eps 1e-3), ReLU."""

    def __init__(self, name: str, stride=1, padding=0):
        super().__init__()
        cin, cout, k = _SPECS[name]
        self.conv = nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _avg3(x: torch.Tensor) -> torch.Tensor:
    # the FID variant's pooling: the padding is not counted
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, n: str):
        super().__init__()
        self.branch1x1 = BasicConv2d(f"{n}.branch1x1")
        self.branch5x5_1 = BasicConv2d(f"{n}.branch5x5_1")
        self.branch5x5_2 = BasicConv2d(f"{n}.branch5x5_2", padding=2)
        self.branch3x3dbl_1 = BasicConv2d(f"{n}.branch3x3dbl_1")
        self.branch3x3dbl_2 = BasicConv2d(f"{n}.branch3x3dbl_2", padding=1)
        self.branch3x3dbl_3 = BasicConv2d(f"{n}.branch3x3dbl_3", padding=1)
        self.branch_pool = BasicConv2d(f"{n}.branch_pool")

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b1, b5, bd, self.branch_pool(_avg3(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, n: str):
        super().__init__()
        self.branch3x3 = BasicConv2d(f"{n}.branch3x3", stride=2)
        self.branch3x3dbl_1 = BasicConv2d(f"{n}.branch3x3dbl_1")
        self.branch3x3dbl_2 = BasicConv2d(f"{n}.branch3x3dbl_2", padding=1)
        self.branch3x3dbl_3 = BasicConv2d(f"{n}.branch3x3dbl_3", stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionC(nn.Module):
    def __init__(self, n: str):
        super().__init__()
        self.branch1x1 = BasicConv2d(f"{n}.branch1x1")
        self.branch7x7_1 = BasicConv2d(f"{n}.branch7x7_1")
        self.branch7x7_2 = BasicConv2d(f"{n}.branch7x7_2", padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(f"{n}.branch7x7_3", padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(f"{n}.branch7x7dbl_1")
        self.branch7x7dbl_2 = BasicConv2d(f"{n}.branch7x7dbl_2", padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(f"{n}.branch7x7dbl_3", padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(f"{n}.branch7x7dbl_4", padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(f"{n}.branch7x7dbl_5", padding=(0, 3))
        self.branch_pool = BasicConv2d(f"{n}.branch_pool")

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for conv in (self.branch7x7dbl_2, self.branch7x7dbl_3, self.branch7x7dbl_4, self.branch7x7dbl_5):
            bd = conv(bd)
        return torch.cat([b1, b7, bd, self.branch_pool(_avg3(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, n: str):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(f"{n}.branch3x3_1")
        self.branch3x3_2 = BasicConv2d(f"{n}.branch3x3_2", stride=2)
        self.branch7x7x3_1 = BasicConv2d(f"{n}.branch7x7x3_1")
        self.branch7x7x3_2 = BasicConv2d(f"{n}.branch7x7x3_2", padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(f"{n}.branch7x7x3_3", padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(f"{n}.branch7x7x3_4", stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = self.branch7x7x3_4(self.branch7x7x3_3(self.branch7x7x3_2(self.branch7x7x3_1(x))))
        return torch.cat([b3, b7, F.max_pool2d(x, 3, stride=2)], 1)


class InceptionE(nn.Module):
    def __init__(self, n: str, pool: str):
        super().__init__()
        self.pool = pool
        self.branch1x1 = BasicConv2d(f"{n}.branch1x1")
        self.branch3x3_1 = BasicConv2d(f"{n}.branch3x3_1")
        self.branch3x3_2a = BasicConv2d(f"{n}.branch3x3_2a", padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(f"{n}.branch3x3_2b", padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(f"{n}.branch3x3dbl_1")
        self.branch3x3dbl_2 = BasicConv2d(f"{n}.branch3x3dbl_2", padding=1)
        self.branch3x3dbl_3a = BasicConv2d(f"{n}.branch3x3dbl_3a", padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(f"{n}.branch3x3dbl_3b", padding=(1, 0))
        self.branch_pool = BasicConv2d(f"{n}.branch_pool")

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        # Mixed_7c of the FID network pools by max
        pooled = _avg3(x) if self.pool == "avg" else F.max_pool2d(x, 3, stride=1, padding=1)
        return torch.cat([b1, b3, bd, self.branch_pool(pooled)], 1)


class InceptionV3FID(nn.Module):
    """pt_inception's FID network: float NHWC images in [0, 1], of any size,
    to ``[N, 2048]`` features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d("Conv2d_1a_3x3", stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d("Conv2d_2a_3x3")
        self.Conv2d_2b_3x3 = BasicConv2d("Conv2d_2b_3x3", padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d("Conv2d_3b_1x1")
        self.Conv2d_4a_3x3 = BasicConv2d("Conv2d_4a_3x3")
        self.Mixed_5b = InceptionA("Mixed_5b")
        self.Mixed_5c = InceptionA("Mixed_5c")
        self.Mixed_5d = InceptionA("Mixed_5d")
        self.Mixed_6a = InceptionB("Mixed_6a")
        self.Mixed_6b = InceptionC("Mixed_6b")
        self.Mixed_6c = InceptionC("Mixed_6c")
        self.Mixed_6d = InceptionC("Mixed_6d")
        self.Mixed_6e = InceptionC("Mixed_6e")
        self.Mixed_7a = InceptionD("Mixed_7a")
        self.Mixed_7b = InceptionE("Mixed_7b", pool="avg")
        self.Mixed_7c = InceptionE("Mixed_7c", pool="max")

    def forward(self, x01: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x01.permute(0, 3, 1, 2), size=(299, 299), mode="bilinear", align_corners=False)
        x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, stride=2)
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
        x = F.max_pool2d(x, 3, stride=2)
        for block in (self.Mixed_5b, self.Mixed_5c, self.Mixed_5d, self.Mixed_6a, self.Mixed_6b, self.Mixed_6c,
                      self.Mixed_6d, self.Mixed_6e, self.Mixed_7a, self.Mixed_7b, self.Mixed_7c):
            x = block(x)
        return x.mean(dim=(2, 3))


# ------------------------------------------------------------------- weights


def random_params(rng: np.random.Generator | int = 0) -> dict[str, torch.Tensor]:
    """Random weights of the exact architecture, as a state dict: the JAX
    package's ``random_params`` draws (N(0, 0.05) convolutions, identity
    BatchNorm), in this module's layout."""
    from bsi_torch.convert import inception_params_from_jax

    if isinstance(rng, int):
        rng = np.random.default_rng(rng)
    params: dict[str, np.ndarray] = {}
    for name, cin, cout, (kh, kw) in _conv_specs():
        params[f"{name}.conv.weight"] = rng.normal(0, 0.05, size=(kh, kw, cin, cout)).astype(np.float32)
        params[f"{name}.bn.weight"] = np.ones(cout, np.float32)
        params[f"{name}.bn.bias"] = np.zeros(cout, np.float32)
        params[f"{name}.bn.running_mean"] = np.zeros(cout, np.float32)
        params[f"{name}.bn.running_var"] = np.ones(cout, np.float32)
    return inception_params_from_jax(params)


def load_params(path: str | Path) -> dict[str, torch.Tensor]:
    """The network's state dict from a pt_inception checkpoint (``.pth`` or
    ``.pt``: a state dict or a pickled module; its ``fc`` head is dropped)
    or from the JAX package's
    converted ``.npz`` (HWIO convolutions)."""
    path = Path(path)
    if path.suffix == ".npz":
        from bsi_torch.convert import inception_params_from_jax

        with np.load(path) as z:
            return inception_params_from_jax({k: z[k] for k in z.files})
    obj = torch.load(path, map_location="cpu", weights_only=False)
    state_dict = obj.state_dict() if hasattr(obj, "state_dict") else obj
    return {key: value.detach().to(torch.float32) if value.is_floating_point() else value.detach()
            for key, value in state_dict.items() if not key.startswith("fc.")}


def build_network(params: Mapping[str, torch.Tensor], *, device=None, dtype=torch.float32) -> InceptionV3FID:
    """The network with ``params`` loaded, in eval mode, on ``device`` (the
    card when None) in ``dtype``."""
    net = InceptionV3FID().to(dtype=dtype)
    net.load_state_dict(dict(params))
    return net.to(resolve_device(device)).eval()


def inception_features(params: Mapping[str, torch.Tensor], x01: torch.Tensor) -> torch.Tensor:
    """2048-d FID features of float images ``[N, H, W, 3]`` in [0, 1], by the
    network with ``params`` on ``x01``'s device, in its dtype."""
    net = build_network(params, device=x01.device, dtype=x01.dtype)
    with torch.inference_mode():
        return net(x01)


def make_embed_fn(params: Mapping[str, torch.Tensor], device=None) -> Callable:
    """``embed(images_uint8) -> [N, 2048]`` float32 features on ``device``
    (the card when None), from uint8 ``[N, H, W, 3]`` (an array or a
    tensor). The convolutions run in exact f32: TF32 is off inside each call
    and the caller's flags are restored after it."""
    net = build_network(params, device=device)
    device = next(net.parameters()).device

    def embed(images_uint8) -> torch.Tensor:
        if not isinstance(images_uint8, torch.Tensor):
            images_uint8 = torch.from_numpy(np.ascontiguousarray(images_uint8))
        x = images_uint8.to(device)
        flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.inference_mode():
                return net(x.to(torch.float32) / 255.0)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags

    return embed


def default_weights_path() -> Path | None:
    """The Inception weights: ``$BSI_TPU_INCEPTION_WEIGHTS``, else the first
    ``data/pt_inception*.pth``, else ``data/pt_inception*.npz``; None when
    there are none."""
    env = os.environ.get("BSI_TPU_INCEPTION_WEIGHTS")
    candidates = [Path(env)] if env else []
    candidates += sorted(Path("data").glob("pt_inception*.pth")) + sorted(Path("data").glob("pt_inception*.npz"))
    for cand in candidates:
        if cand.exists():
            return cand
    return None
