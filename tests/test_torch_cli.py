"""The port's command line (``python -m bpldenoising_tpu_torch``): the
cases of the JAX package's tests/test_cli.py with ``--device cpu`` (the
kernels' plain versions), the numbers it prints against the API's,
make-dataset against the JAX CLI's dataset, and the flags that are not
ported yet, which exit with status 2 and name their ROADMAP.md item (item
7's flags run)."""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from bpldenoising_tpu_torch.__main__ import main
from bpldenoising_tpu_torch.experiments import api as tapi
from test_torch_fused import (one_torch_thread,  # noqa: F401 (autouse)
                              results_in_tmp)

CPU = ["--device", "cpu"]


def _budget(monkeypatch, n=30):
    """TVDenoise (validate-tv's denoiser) at ``n`` iterations."""
    real = tapi.TVDenoise

    @functools.wraps(real)
    def short(*args, **kw):
        kw["maxiter"] = n
        return real(*args, **kw)
    monkeypatch.setattr(tapi, "TVDenoise", short)


def test_scalar_tv(capsys):
    main(["scalar-tv", "--dataset", "circle", "--maxiter", "1",
          "--inner-maxiter", "50"] + CPU)
    out = capsys.readouterr().out
    assert "x =" in out and "cost =" in out
    assert os.path.isfile("output/circle_128_10/"
                          "tv_optimal_parameter_scalar_circle_128_10.txt")


def test_validate_tv(capsys, monkeypatch):
    _budget(monkeypatch)
    main(["validate-tv", "0.1", "--dataset", "circle"] + CPU)
    printed = capsys.readouterr().out.split()
    assert len(printed) == 2
    out = tapi.validate_tv_parameter(0.1, dataset_name="circle",
                                     device="cpu")
    assert [float(v) for v in printed] == [out["cost"], out["mean_psnr"]]


def test_cost_sweep(capsys):
    pytest.importorskip("matplotlib")
    main(["cost-sweep", "--dataset", "circle", "--points", "3",
          "--maxiter", "100", "--plot"] + CPU)
    path = "output/circle_128_10/circle_128_10_cost.npz"
    assert os.path.exists(path)
    costs = np.load(path)["costs"]
    want = tapi.generate_scalar_tv_cost(
        "circle", np.logspace(np.log10(1e-3), 0.0, 3), maxiter=100,
        device="cpu")
    np.testing.assert_array_equal(costs, want)
    base = capsys.readouterr().out.strip()
    assert os.path.exists(base + ".png")


def test_bad_command_exits():
    with pytest.raises(SystemExit):
        main(["not-a-command"])


@pytest.mark.parametrize("argv,item", [
    (["--trace", "tr"], 7), (["--checkpoint", "--method", "tr_fused"], 7),
    (["--resume", "--method", "tr_fused"], 7),
    (["--log-every", "2", "--method", "tr_fused"], 7),
    (["--data-parallel"], 10), (["--backend", "jnp"], None)],
    ids=["trace", "checkpoint", "resume", "log_every", "data_parallel",
         "backend"])
def test_unported_flags_exit_and_name_their_item(capsys, argv, item):
    """What is not ported exits with status 2, names its ROADMAP.md item
    and writes nothing; item 7's flags and item 10's --data-parallel (one
    shard with --device cpu) run since they were ported, as in the JAX
    package: --trace writes the Chrome trace, --checkpoint and
    --resume (with no checkpoint yet: a fresh run) the checkpoint at the
    fused loop's segment end (the host loop writes one only after an
    accepted step), --log-every the log with real times."""
    run = ["scalar-tv", "--dataset", "circle", "--maxiter", "1",
           "--inner-maxiter", "10"] + CPU + argv
    log = "output/circle_128_10/tv_optimal_parameter_scalar_circle_128_10"
    if item in (7, 10):
        main(run)
        assert "iterations = 1" in capsys.readouterr().out
        with open(log + ".txt") as fh:
            rows = [r.split() for r in fh if not r.startswith("#")]
        assert len(rows) == 1
        if "--trace" in argv:
            assert os.path.getsize("tr/trace.json") > 0
        if "--checkpoint" in argv or "--resume" in argv:
            assert os.path.isfile(log + "_ckpt.npz")
        if "--log-every" in argv:
            assert float(rows[0][1]) > 0
        return
    with pytest.raises(SystemExit) as exit_:
        main(run)
    assert exit_.value.code == 2
    err = capsys.readouterr().err
    assert ("backend" if item is None else f"§1 item {item}") in err
    assert not os.path.exists(log + ".txt")


@pytest.mark.parametrize("argv", [
    ["--size", "32"], ["--phantom", "facets", "--size", "24", "--seed", "3"],
    ["--size", "20", "--noise", "impulse", "--density", "0.3"]],
    ids=["circle", "facets", "impulse"])
def test_make_dataset_is_not_ported(capsys, tmp_path, argv):
    """make-dataset (ported; the name is the old refusal's) writes the
    dataset the JAX CLI writes from the same arguments: the same file list
    and the same decoded arrays; --from-images reads grayscale PNGs."""
    from bpldenoising_tpu.__main__ import main as jmain
    from bpldenoising_tpu.data import load_dataset as j_load
    from bpldenoising_tpu_torch.data import load_dataset as t_load
    outs = []
    for run, root in ((main, "port"), (jmain, "jax")):
        run(["make-dataset", "cli_ds", "--out-root", str(tmp_path / root)]
            + argv)
        outs.append(capsys.readouterr().out.strip())
    assert outs == [str(tmp_path / r / "cli_ds") for r in ("port", "jax")]
    assert (tmp_path / "port" / "cli_ds" / "filelist.txt").read_text() == \
        (tmp_path / "jax" / "cli_ds" / "filelist.txt").read_text()
    for g, w in zip(t_load(outs[0]), j_load(outs[1])):
        assert np.array_equal(g, w)
    if argv[0] == "--size":
        src = str(tmp_path / "port" / "cli_ds" / "cli_ds_data_1.png")
        main(["make-dataset", "from_png", "--out-root", str(tmp_path),
              "--from-images", src, "--sigma", "0.05"])
        tru, _ = t_load(capsys.readouterr().out.strip())
        assert np.array_equal(tru, t_load(outs[0])[1])


def test_single_loop_budget_flags(capsys):
    main(["scalar-tv", "--dataset", "circle", "--method", "single_loop",
          "--sl-outer", "5", "--sl-inner", "10", "--sl-adj", "3",
          "--sl-lr", "0.05"] + CPU)
    out = capsys.readouterr().out
    assert "iterations = 5" in out


@pytest.mark.parametrize("cmd,extra", [
    ("validate-tgv", ["0.08", "0.04"]), ("validate-tvl1", ["1.9"]),
    ("validate-vtv", ["0.16"]),
    ("validate-sumregs", ["0.03", "0.02", "0.01"])])
def test_other_validations_print_cost_and_psnr(capsys, monkeypatch, cmd,
                                               extra):
    """validate-tgv, -tvl1, -vtv and -sumregs print the API's cost and
    mean PSNR (budgets cut to a few iterations)."""
    from bpldenoising_tpu_torch.experiments import tgv, vtv
    for mod, name in ((tgv, "TGVDenoise"), (vtv, "VTVDenoise")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, functools.partial(real, maxiter=5))
    real_pdps = tapi.denoise_pdps
    monkeypatch.setattr(tapi, "denoise_pdps",
                        lambda *a, **k: real_pdps(*a, **dict(k, maxiter=5)))
    args = ["--x64", cmd] + extra + CPU
    if cmd == "validate-tvl1":
        args += ["--maxiter", "5", "--dataset", "circle_sp"]
    elif cmd != "validate-vtv":
        args += ["--dataset", "circle"]
    main(args)
    printed = [float(v) for v in capsys.readouterr().out.split()]
    assert len(printed) == 2 and all(np.isfinite(printed))


def test_module_runs_as_a_program(tmp_path):
    """python -m bpldenoising_tpu_torch: the help lists the subcommands;
    without a card the default --device cuda fails instead of running on
    the CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = subprocess.run([sys.executable, "-m", "bpldenoising_tpu_torch",
                          "--help"], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0
    for cmd in ("scalar-tv", "validate-tvl1", "cost-sweep", "make-dataset"):
        assert cmd in out.stdout
