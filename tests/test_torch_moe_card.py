"""The port's MoE FFN on the card: ``layers.moe`` against its plain one-hot
version ``moe_plain`` on CUDA tensors, at the MoE smoke configs' widths and
at qwen2-moe-a2.7b's full width for one layer, and equal bits on reruns.
Needs an NVIDIA GPU (``cuda`` marker; skips without one).  Imports nothing
of JAX: the CPU twins against the reference are in ``test_torch_moe.py``.

Tolerance: the picks, kept slots and aux equal; the output within
``MOE_TOL`` of its scale: float32 1e-5 (the expert products and the
combine sum in other orders), bf16 two bf16 ulps, ``2**-6`` (the expert
products of ``moe``'s expert-major slots and of ``moe_plain``'s one-hot
layout are different cuBLAS calls, which may round an output apart once,
and the combine's float32 sums, in other orders, may round apart once
more), below ``chip_smoke.SERVE_TOL_BF16`` (2e-2).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models.params import init_params

MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the MoE checks run on the card")
    return torch.device("cuda")


def _check(cfg, dtype, b: int, s: int, seed: int, device: str = "cuda"):
    p = init_params(L.moe_params(cfg), dtype, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=device).to(dtype)
    h = L.rmsnorm(p["ln"], x)
    _, r = L.moe_route(p, cfg, h)
    _, rp = L.moe_route_plain(p, cfg, h)
    assert torch.equal(r.idx, rp.idx) and torch.equal(r.keep, rp.keep)
    assert torch.equal(torch.where(r.keep, r.pos, -1), torch.where(rp.keep, rp.pos, -1))
    y, aux = L.moe(p, cfg, x)
    yp, auxp = L.moe_plain(p, cfg, x)
    assert torch.equal(aux, auxp)
    assert bool(torch.isfinite(y).all())
    err = float((y.float() - yp.float()).abs().max())
    scale = float(yp.float().abs().max())
    assert err <= MOE_TOL[dtype] * scale, (err, scale)
    y2, aux2 = L.moe(p, cfg, x)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)  # equal bits on a rerun
    return r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
def test_moe_on_the_card_matches_moe_plain_at_smoke_width(cuda, arch, dtype):
    """Smoke widths, 2 x 40 positions at a capacity factor that drops
    picks, and a decode step's single position."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), capacity_factor=0.5)
    r = _check(cfg, dtype, 2, 40, seed=1)
    assert not bool(r.keep.all())
    r = _check(cfg, dtype, 3, 1, seed=2)
    assert r.cap == 1 and bool(r.keep.all())


@pytest.mark.cuda
def test_moe_on_the_card_matches_moe_plain_at_qwen2_moe_width(cuda):
    """One qwen2-moe-a2.7b MoE layer at full width (64 padded experts of
    2,048 x 1,408, the shared expert of 5,632), bf16, 16 requests of 64
    positions: the serving prefill's routing (capacity 5)."""
    cfg = get_config("qwen2-moe-a2.7b")
    r = _check(cfg, torch.bfloat16, 16, 64, seed=3)
    assert r.cap == 5 and int(r.idx.max()) < cfg.n_experts
