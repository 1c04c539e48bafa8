"""The CUDA kernel against its plain version, on the card.

Marked `gpu`: each test decides inside itself whether a CUDA device is
present and skips without one, so every pytest worker collects the same
tests. Run on a machine with the card (--noconftest: tests/conftest.py
imports JAX, which the port's machine need not have):

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest

Tolerance 2e-5 is the JAX package's kernel tolerance (tests/test_pallas.py);
the kernel rounds the Gaussian exponent's inputs exactly as the plain
version does (csrc/fused_fwd.cu, gauss_exponent_rn), so the two differ only
by summation order.
"""

import numpy as np
import pytest
import torch

from sgrt_tpu_torch.models.gaussians import grid_scene
from sgrt_tpu_torch.ops import cuda_kernel as tk
from sgrt_tpu_torch.ops.frame import render_orbit_frame

pytestmark = pytest.mark.gpu


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _inputs(dev, b=5, n=96, r=200, counts=(96, 17, 0, 40, 1000), seed=0):
    g = torch.Generator().manual_seed(seed)
    oc = torch.rand((b, n, 3), generator=g) * 2 - 1 + torch.tensor([0.0, 0.0, 2.5])
    sig = torch.rand((b, n), generator=g) * 0.15 + 0.05
    mag = torch.rand((b, n), generator=g) * 0.4 + 0.1
    alb = torch.rand((b, n, 3), generator=g)
    d = torch.randn((b, 3, r), generator=g) * torch.tensor([0.3, 0.3, 1.0])[None, :, None]
    d = d / d.norm(dim=1, keepdim=True)
    cnt = torch.tensor(counts, dtype=torch.int32)
    return [t.to(dev).contiguous() for t in (oc, sig, mag, alb, d, cnt)]


@pytest.mark.parametrize("erf_name,exp_name,pb,qb", [
    ("as5", "exact", 8, 32), ("as5", "exact", 16, 16), ("as3", "fast", 8, 32),
])
def test_kernel_matches_plain(erf_name, exp_name, pb, qb):
    args = _inputs(_card())
    before = tk.FUSED_FWD.launches
    out = tk.fused_forward(*args, pb=pb, qb=qb, erf_name=erf_name, exp_name=exp_name)
    torch.cuda.synchronize()
    assert tk.FUSED_FWD.launches == before + 1
    ref = tk.fused_forward_plain(*args, erf_name=erf_name, exp_name=exp_name)
    assert torch.isfinite(out).all()
    assert (out[2] == 0).all()
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), atol=2e-5)


def test_kernel_refuses_grad_and_unported_names():
    args = _inputs(_card())
    with pytest.raises(NotImplementedError, match="backward"):
        tk.fused_forward(args[0].clone().requires_grad_(True), *args[1:])
    with pytest.raises(ValueError, match="erf"):
        tk.fused_forward(*args, erf_name="spline")


def test_frame_kernel_route_on_card():
    dev = _card()
    scene = grid_scene(8, device=dev)
    kw = dict(width=64, height=64, tiles=4, capacity=64)
    before = tk.FUSED_FWD.launches
    img, ovf = render_orbit_frame(scene, 23.0, backend="kernel", **kw)
    assert tk.FUSED_FWD.launches == before + 1 and int(ovf) == 0
    ref, _ = render_orbit_frame(scene, 23.0, backend="torch", **kw)
    # 8e-5: the float32 conditioning bound of tests/test_torch_frame.py
    np.testing.assert_allclose(img.cpu().numpy(), ref.cpu().numpy(), atol=8e-5)
    un, _ = render_orbit_frame(scene, 23.0, backend="kernel", use_tiling=False,
                               width=32, height=32)
    assert tk.FUSED_FWD.launches == before + 2 and torch.isfinite(un).all()
