"""Rows 9–10's kernel (``csrc/single_loop.cu``) in its mesh form: each
shard's ``first_order_cuda.Session`` runs a step piece by piece up to its
sum points (every CG inner product, then the gradient maps and the cost)
with the sums over the shards written back on the card.

- On the CPU: a session refuses tensors off the card before the device,
  and a mesh of CPU shards never builds one.
- On the card (marked ``cuda``; they skip without one): the kernel's mesh
  form against the plain mesh form (the same shards on the CPU) in
  float64 at 1e-9 relative on uneven bands, the four parameterizations
  and both CG forms, with the single form's launches a step a shard; one
  shard is the single form bit for bit and one image over two shards (an
  all-padding shard) too; segments equal one segment bit for bit.

This file imports no JAX: ``python -m pytest --noconftest
tests/test_torch_first_order_tv_mesh_card.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch.bilevel import first_order as tfo
from bpldenoising_tpu_torch.bilevel import first_order_cuda as tfc
from bpldenoising_tpu_torch.models import sumregs_model, tv_model
from bpldenoising_tpu_torch.parallel import make_batch_mesh

KW = dict(outer=12, n_inner=8, n_adj=4, lr=0.05)
TOL_F64 = 1e-9
PARAMS = {
    "tv-scalar": (tv_model, 0.02),
    "tv-patch": (tv_model, np.full((2, 2), 0.02)),
    "sumregs-vector": (sumregs_model, [0.02, 0.015, 0.01]),
    "sumregs-patch": (sumregs_model, np.full((2, 2, 3), 0.02)),
}
VARIANTS = ["classic", "pipelined"]


def disc_stack(B, M, N, dtype=torch.float64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(M), np.arange(N), indexing="ij")
    disc = ((xx - N / 2) ** 2 + (yy - M / 2) ** 2
            < (min(M, N) / 3) ** 2).astype(float)
    clean = np.stack([disc] * B)
    noisy = clean + 0.1 * rng.standard_normal(clean.shape)
    return (torch.as_tensor(clean, dtype=dtype),
            torch.as_tensor(noisy, dtype=dtype))


def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def _mesh(device, n):
    return make_batch_mesh(devices=[device] * n)


def test_session_refuses_tensors_off_the_card():
    ut, f = disc_stack(2, 8, 8)
    carry = tfo._init_carry(f, torch.tensor(0.05, dtype=f.dtype), K=1,
                            param_shape=())
    with pytest.raises(ValueError, match="CUDA"):
        tfc.Session(ut, f, carry, model=tv_model(), outer=1, n_inner=1,
                    n_adj=1, pop=None, param_shape=(), lr=0.05, gamma=1e4,
                    tau0=5.0, sigma0=0.2, beta1=0.9, beta2=0.999, eps=1e-8,
                    mesh=True)


def test_cpu_mesh_builds_no_session(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("a CUDA session was made")
    monkeypatch.setattr(tfc, "Session", forbidden)
    ut, f = disc_stack(3, 8, 8)
    before = tfc.launches
    res = tfo.single_loop_tv_learn(ut, f, 0.05, mesh=_mesh("cpu", 2),
                                   **dict(KW, outer=2))
    assert tfc.launches == before and res.u.shape == f.shape


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; they skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest "
                    "tests/test_torch_first_order_tv_mesh_card.py -m cuda)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("shape,shards", [((3, 20, 16), 2), ((5, 22, 24), 4)])
def test_kernel_mesh_matches_plain_mesh(cuda_device, shape, shards, name,
                                        variant):
    tm, x0 = PARAMS[name]
    ut, f = disc_stack(*shape)
    s0, k0 = tfc.launches, tfc.kernel_launches
    k = tfo.single_loop_learn(ut.to(cuda_device), f.to(cuda_device), x0,
                              tm(), mesh=_mesh(cuda_device, shards),
                              cg_variant=variant, **KW)
    assert tfc.launches - s0 == shards
    assert tfc.kernel_launches - k0 == shards * (
        KW["outer"] * tfc.launches_per_step(KW["n_adj"], variant) + 1)
    p = tfo.single_loop_learn(ut, f, x0, tm(), mesh=_mesh("cpu", shards),
                              cg_variant=variant, **KW)
    for a, b in zip(k[:6], p[:6]):
        assert rel(a, b) <= TOL_F64
    assert k.u.shape == f.shape


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", ["tv-scalar", "sumregs-patch"])
def test_one_shard_and_a_padding_shard_are_the_single_form(
        cuda_device, name, variant, dtype):
    tm, x0 = PARAMS[name]
    ut, f = (a.to(cuda_device) for a in disc_stack(2, 20, 16, dtype))
    kw = dict(KW, cg_variant=variant)
    single = tfo.single_loop_learn(ut, f, x0, tm(), **kw)
    one = tfo.single_loop_learn(ut, f, x0, tm(), mesh=_mesh(cuda_device, 1),
                                **kw)
    assert all(torch.equal(a, b) for a, b in zip(single[:6], one[:6]))
    single = tfo.single_loop_learn(ut[:1], f[:1], x0, tm(), **kw)
    two = tfo.single_loop_learn(ut[:1], f[:1], x0, tm(),
                                mesh=_mesh(cuda_device, 2), **kw)
    assert all(torch.equal(a, b) for a, b in zip(single[:6], two[:6]))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
def test_segments_equal_one_segment_on_the_card(cuda_device, variant):
    ut, f = (a.to(cuda_device) for a in disc_stack(5, 20, 16))
    kw = dict(KW, outer=9, cg_variant=variant)
    whole = tfo.single_loop_sumregs_learn(ut, f, [0.02, 0.015, 0.01],
                                          mesh=_mesh(cuda_device, 2), **kw)
    s0 = tfc.launches
    seg = tfo.single_loop_sumregs_learn(ut, f, [0.02, 0.015, 0.01],
                                        mesh=_mesh(cuda_device, 2),
                                        log_every=4, **kw)
    assert tfc.launches - s0 == 6
    assert all(torch.equal(a, b) for a, b in zip(whole[:6], seg[:6]))
