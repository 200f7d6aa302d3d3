"""The port's multi-host set-up (``parallel/distributed.py``): the JAX
package's six environment cases (tests/test_parallel.py:269-320) with
``torch.distributed.init_process_group`` mocked, the markers of a PyTorch
launch in place of JAX's coordinator variables, and one real two-process
gloo run on the CPU: a sharded TV evaluation across the two ranks (two
shards each) equals the one-process mesh of the same four shards to
1e-12 (the same shards; only the all_reduce adds the ranks' sums in
another grouping)."""

import multiprocessing
import queue
import socket

import numpy as np
import pytest
import torch

from bpldenoising_tpu_torch.parallel import distributed as dist_mod
from bpldenoising_tpu_torch.parallel import initialize_distributed

MARKERS = (dist_mod._CLUSTER_ADDRESS_VARS + dist_mod._CLUSTER_COUNT_VARS
           + dist_mod._WORLD_VARS + dist_mod._RANK_VARS)


@pytest.fixture
def clean_env(monkeypatch):
    for v in MARKERS:
        monkeypatch.delenv(v, raising=False)
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda **kw: calls.append(kw))
    return calls


def test_noop_without_cluster_env(clean_env):
    assert initialize_distributed() is False
    assert clean_env == []


@pytest.mark.parametrize("var", ["SLURM_JOB_NUM_NODES",
                                 "OMPI_COMM_WORLD_SIZE"])
def test_single_node_or_process_is_noop(clean_env, monkeypatch, var):
    """A one-node Slurm job or a single-process mpirun needs no group."""
    monkeypatch.setenv(var, "1")
    assert initialize_distributed() is False
    assert clean_env == []


def test_ompi_multi_process_triggers(clean_env, monkeypatch):
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "2")
    assert initialize_distributed() is True
    assert clean_env[0]["world_size"] == 4 and clean_env[0]["rank"] == 2


def test_cluster_env_triggers_initialize(clean_env, monkeypatch):
    """torchrun's markers: MASTER_ADDR with a world size above one starts
    the group from the environment (env://); a world of one does not."""
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert initialize_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    assert initialize_distributed() is True
    (kw,) = clean_env
    assert "init_method" not in kw
    assert (kw["world_size"], kw["rank"]) == (2, 1)
    assert kw["backend"] == ("nccl" if torch.cuda.is_available() else "gloo")


def test_explicit_args_force_initialize(clean_env):
    assert initialize_distributed("1.2.3.4:99", 4, 0) is True
    (kw,) = clean_env
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (
        "tcp://1.2.3.4:99", 4, 0)


def _dataset():
    rng = np.random.default_rng(0)
    n = 16
    x, y = np.meshgrid(np.arange(n), np.arange(n))
    clean = ((x - n / 2) ** 2 + (y - n / 2) ** 2 < (n / 3) ** 2).astype(float)
    true_ = np.stack([clean] * 4) + 0.01 * rng.standard_normal((4, n, n))
    return true_, true_ + 0.1 * rng.standard_normal((4, n, n))


def _evaluate(n_shards):
    from bpldenoising_tpu_torch.parallel import (
        make_batch_mesh, make_sharded_tv_learning_function)
    from bpldenoising_tpu_torch.solvers.hypergrad import HypergradConfig
    cfg = HypergradConfig(act_tol=1e-3, gamma=1e3, al_iters=2, cg_tol=1e-10,
                          cg_maxiter=1000)
    lf = make_sharded_tv_learning_function(
        make_batch_mesh(devices=["cpu"] * n_shards), maxiter=60, cfg=cfg)
    u, cost, grad = lf(0.1, _dataset(), 0.1)
    return u.numpy(), float(cost), float(grad)


def _rank_main(rank, port, out):
    torch.set_num_threads(1)
    try:
        assert initialize_distributed(f"localhost:{port}", 2, rank)
        out.put((rank,) + _evaluate(2))
    except BaseException as e:   # noqa: BLE001 — reported to the parent
        out.put((rank, repr(e)))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_matches_one_process_mesh():
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, port, out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = {}
        for _ in range(2):
            item = out.get(timeout=60)
            got[item[0]] = item[1:]
    except queue.Empty:
        pytest.fail("the two ranks did not report within 60 s")
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    for r in (0, 1):
        assert len(got[r]) == 3, got[r]
    u, cost, grad = _evaluate(4)
    for r in (0, 1):
        ur, cr, gr = got[r]
        np.testing.assert_allclose(cr, cost, rtol=1e-12)
        np.testing.assert_allclose(gr, grad, rtol=1e-12)
        # each rank returns the images of its two global shards
        np.testing.assert_allclose(ur, u[2 * r:2 * r + 2], atol=1e-12)
