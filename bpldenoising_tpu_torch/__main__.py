"""Command-line interface of the port (counterpart of
``bpldenoising_tpu.__main__``): the same subcommands and flags over the
port's experiment API, plus ``--device`` (default ``cuda``; ``cpu`` runs
the kernels' plain versions)::

    python -m bpldenoising_tpu_torch scalar-tv --dataset faces_train --num-samples 10
    python -m bpldenoising_tpu_torch patch-tv --dataset cameraman_128_5 --patch 2
    python -m bpldenoising_tpu_torch scalar-sumregs --dataset circle
    python -m bpldenoising_tpu_torch validate-tv 0.07 --dataset faces_val
    python -m bpldenoising_tpu_torch cost-sweep --dataset cameraman_128_5 \\
        --lo 1e-3 --hi 1 --points 50 --plot

``--x64`` runs in float64 on the chosen device; ``--backend`` takes only
``auto``.  ``--trace DIR`` writes a ``torch.profiler`` Chrome trace of a
learn to ``DIR/trace.json``.  ``--data-parallel`` shards the image batch
over every visible card (one shard with ``--device cpu``), with every
``--method`` in every learn subcommand.  ``make-dataset`` writes a loadable
(true, noisy) PNG dataset from a built-in phantom or grayscale PNGs::

    python -m bpldenoising_tpu_torch make-dataset mycircle_128_10 --size 128
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

def _device(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (the CUDA kernels) or cpu (their plain "
                        "versions)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bpldenoising_tpu_torch")
    ap.add_argument("--x64", action="store_true",
                    help="run in float64 on the chosen device")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        _device(p)
        p.add_argument("--dataset", default="cameraman_128_5")
        p.add_argument("--num-samples", type=int, default=1)
        p.add_argument("--maxiter", type=int, default=20)
        p.add_argument("--inner-maxiter", type=int, default=5000)
        p.add_argument("--checkpoint", action="store_true")
        p.add_argument("--resume", action="store_true")
        p.add_argument("--visualise", action="store_true")
        p.add_argument("--dtype", default=None,
                       help="float32|float64 (default: float64)")
        p.add_argument("--backend", default="auto",
                       choices=["auto", "jnp", "pallas"],
                       help="only auto: --device chooses what runs")
        p.add_argument("--method", default="tr",
                       choices=["tr", "tr_fused", "single_loop"])
        p.add_argument("--inner-tol", type=float, default=None,
                       help="PDPS early-stop tolerance (enables "
                            "warm-started inner solves)")
        p.add_argument("--log-every", type=int, default=None,
                       help="tr_fused segmented dispatch: a host hop every "
                            "N outer iterations (per-segment wall times, "
                            "checkpointing)")
        p.add_argument("--data-parallel", action="store_true",
                       help="shard the image batch over all local devices")
        p.add_argument("--trace", default=None, metavar="DIR",
                       help="write a torch.profiler Chrome trace of the "
                            "learn to DIR/trace.json")
        p.add_argument("--sl-outer", type=int, default=None,
                       help="single_loop: outer (Adam) steps")
        p.add_argument("--sl-inner", type=int, default=None,
                       help="single_loop: PD iterations per outer step")
        p.add_argument("--sl-adj", type=int, default=None,
                       help="single_loop: adjoint CG steps per outer step")
        p.add_argument("--sl-lr", type=float, default=None,
                       help="single_loop: Adam rate on log alpha")

    p = sub.add_parser("scalar-tv");      common(p)
    p.add_argument("--alpha0", type=float, default=0.1)
    p = sub.add_parser("patch-tv");       common(p)
    p.add_argument("--patch", type=int, default=2)
    p.add_argument("--alpha0", type=float, default=1e-4)
    p = sub.add_parser("scalar-sumregs"); common(p)
    p.add_argument("--alpha0", type=float, default=1e-3)
    p = sub.add_parser("patch-sumregs");  common(p)
    p.add_argument("--patch", type=int, default=2)
    p.add_argument("--alpha0", type=float, default=1e-3)

    p = sub.add_parser("validate-tv");    _device(p)
    p.add_argument("parameter", type=float)
    p.add_argument("--dataset", default="cameraman_128_5")
    p = sub.add_parser("validate-sumregs"); _device(p)
    p.add_argument("parameter", type=float, nargs=3)
    p.add_argument("--dataset", default="cameraman_128_5")

    p = sub.add_parser("cost-sweep");     _device(p)
    p.add_argument("--dataset", default="cameraman_128_5")
    p.add_argument("--lo", type=float, default=1e-3)
    p.add_argument("--hi", type=float, default=1.0)
    p.add_argument("--points", type=int, default=50)
    p.add_argument("--num-samples", type=int, default=1)
    p.add_argument("--maxiter", type=int, default=10000)
    p.add_argument("--plot", action="store_true")

    p = sub.add_parser("scalar-tgv", help="learn the TGV² weight pair "
                       "(alpha1, alpha0)")
    common(p)
    p.add_argument("--alpha0", type=float, nargs=2, default=[0.05, 0.05],
                   metavar=("A1", "A0"),
                   help="initial (first-order, second-order) weights")
    p = sub.add_parser("patch-tgv", help="learn spatially-varying TGV "
                       "weight maps")
    common(p)
    p.add_argument("--patch", type=int, default=2)
    p.add_argument("--alpha0", type=float, default=0.05)
    p = sub.add_parser("validate-tgv");   _device(p)
    p.add_argument("parameter", type=float, nargs=2)
    p.add_argument("--dataset", default="cameraman_128_5")

    p = sub.add_parser("scalar-vtv", help="learn the vectorial (color) TV "
                       "coupling weight on planar RGB stacks")
    common(p)
    p.add_argument("--alpha0", type=float, default=0.05)
    p = sub.add_parser("patch-vtv", help="learn a spatially-varying "
                       "vectorial-TV weight patch grid")
    common(p)
    p.add_argument("--patch", type=int, default=2)
    p.add_argument("--alpha0", type=float, default=0.05)
    p = sub.add_parser("validate-vtv");   _device(p)
    p.add_argument("parameter", type=float)
    p.add_argument("--dataset", default="color_disks_128_10")

    p = sub.add_parser("scalar-tvl1", help="learn the TV-L1 weight "
                       "(impulse noise, Huber-smoothed surrogate)")
    common(p)
    p.set_defaults(dataset="circle_sp_128_20")
    p.add_argument("--alpha0", type=float, default=0.4)
    p = sub.add_parser("patch-tvl1", help="learn a spatially-varying "
                       "TV-L1 weight patch grid")
    common(p)
    p.set_defaults(dataset="circle_sp_128_20")
    p.add_argument("--patch", type=int, default=2)
    p.add_argument("--alpha0", type=float, default=0.4)
    p = sub.add_parser("validate-tvl1", help="TV-L1 denoise at a fixed "
                       "weight + quality table")
    _device(p)
    p.add_argument("parameter", type=float)
    p.add_argument("--dataset", default="circle_sp_128_20")
    p.add_argument("--maxiter", type=int, default=10000)

    p = sub.add_parser(
        "make-dataset",
        help="synthesize a loadable (true, noisy) PNG dataset from images "
             "or a built-in phantom")
    p.add_argument("name", help="dataset dir name, e.g. mycircle_128_10")
    p.add_argument("--from-images", nargs="*", default=None, metavar="PNG",
                   help="grayscale source images (default: built-in phantom)")
    p.add_argument("--phantom", default="circle",
                   choices=["circle", "ramp", "pyramid", "facets"],
                   help="built-in phantom when no source images given "
                        "(circle: piecewise constant; ramp, pyramid, "
                        "facets: piecewise affine)")
    p.add_argument("--size", type=int, default=128,
                   help="phantom resolution when no source images given")
    p.add_argument("--sigma", type=float, default=0.1,
                   help="Gaussian noise std in [0, 1] units")
    p.add_argument("--noise", default="gaussian",
                   choices=["gaussian", "impulse"],
                   help="impulse = salt and pepper at --density")
    p.add_argument("--density", type=float, default=0.2,
                   help="impulse-noise pixel fraction")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-root", default=None,
                   help="parent dir (default: the bundled datasets dir)")

    args = ap.parse_args(argv)
    try:
        return _dispatch(args)
    except (ValueError, FileNotFoundError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)


def _dispatch(args):
    from bpldenoising_tpu_torch.utils.profiling import trace

    if args.cmd == "make-dataset":
        return _make_dataset(args)
    # only the learns take --trace
    with trace(getattr(args, "trace", None)):
        return _run(args)


def _make_dataset(args):
    from bpldenoising_tpu_torch.data import (add_impulse_noise,
                                             affine_phantom, circle_phantom,
                                             make_dataset, read_png_gray)
    if args.from_images:
        imgs = [read_png_gray(f) for f in args.from_images]
    elif args.phantom == "circle":
        imgs = [circle_phantom(args.size)]
    else:
        imgs = [affine_phantom(args.size, kind=args.phantom,
                               seed=args.seed)]
    noisy = None
    if args.noise == "impulse":
        noisy = [add_impulse_noise(im, args.density, args.seed)
                 for im in imgs]
    print(make_dataset(args.name, imgs, sigma=args.sigma, seed=args.seed,
                       out_root=args.out_root, noisy_images=noisy))


def _run(args):
    from bpldenoising_tpu_torch import experiments as ex

    dev = dict(device=args.device)
    x64 = dict(dtype="float64") if args.x64 else {}

    def kw():
        d = dict(dataset_name=args.dataset, num_samples=args.num_samples,
                 maxiter=args.maxiter, inner_maxiter=args.inner_maxiter,
                 checkpoint=args.checkpoint, resume=args.resume,
                 backend=args.backend, method=args.method,
                 inner_tol=args.inner_tol,
                 data_parallel=bool(args.data_parallel), **dev, **x64)
        if args.dtype:
            d["dtype"] = args.dtype
        if args.log_every is not None:
            d["log_every"] = args.log_every
        for k in ("sl_outer", "sl_inner", "sl_adj", "sl_lr"):
            v = getattr(args, k, None)
            if v is not None:
                d[k] = v
        return d

    def grid(k=None):
        shape = (args.patch, args.patch) + (() if k is None else (k,))
        return args.alpha0 * np.ones(shape)

    def validated(out):
        print(out["cost"], out["mean_psnr"])

    if args.cmd == "scalar-tv":
        res = ex.scalar_bilevel_tv_learn(
            visualise=args.visualise, alpha0=args.alpha0, **kw())
    elif args.cmd == "patch-tv":
        res = ex.patch_bilevel_tv_learn(
            visualise=args.visualise, alpha0=grid(), delta0=args.alpha0,
            **kw())
    elif args.cmd == "scalar-sumregs":
        res = ex.scalar_bilevel_sumregs_learn(
            visualise=args.visualise, alpha0=np.full(3, args.alpha0), **kw())
    elif args.cmd == "patch-sumregs":
        res = ex.patch_bilevel_sumregs_learn(
            visualise=args.visualise, alpha0=grid(3), **kw())
    elif args.cmd == "scalar-tgv":
        res = ex.scalar_bilevel_tgv_learn(
            visualise=args.visualise, alpha0=np.asarray(args.alpha0), **kw())
    elif args.cmd == "patch-tgv":
        res = ex.patch_bilevel_tgv_learn(
            visualise=args.visualise, alpha0=grid(2), **kw())
    elif args.cmd == "scalar-vtv":
        res = ex.scalar_bilevel_vtv_learn(
            visualise=args.visualise, alpha0=args.alpha0, **kw())
    elif args.cmd == "patch-vtv":
        res = ex.patch_bilevel_vtv_learn(
            visualise=args.visualise, alpha0=grid(), **kw())
    elif args.cmd == "scalar-tvl1":
        res = ex.scalar_bilevel_tvl1_learn(
            visualise=args.visualise, alpha0=args.alpha0, **kw())
    elif args.cmd == "patch-tvl1":
        res = ex.patch_bilevel_tvl1_learn(
            visualise=args.visualise, alpha0=grid(), **kw())
    elif args.cmd == "validate-tv":
        return validated(ex.validate_tv_parameter(
            args.parameter, dataset_name=args.dataset, **dev, **x64))
    elif args.cmd == "validate-sumregs":
        return validated(ex.validate_sumregs_parameter(
            np.asarray(args.parameter), dataset_name=args.dataset, **dev,
            **x64))
    elif args.cmd == "validate-tgv":
        return validated(ex.validate_tgv_parameter(
            np.asarray(args.parameter), dataset_name=args.dataset, **dev,
            **x64))
    elif args.cmd == "validate-vtv":
        return validated(ex.validate_vtv_parameter(
            args.parameter, dataset_name=args.dataset, **dev, **x64))
    elif args.cmd == "validate-tvl1":
        return validated(ex.validate_tvl1_parameter(
            args.parameter, dataset_name=args.dataset,
            inner_maxiter=args.maxiter, **dev, **x64))
    elif args.cmd == "cost-sweep":
        ex.generate_scalar_tv_cost(
            args.dataset, np.logspace(np.log10(args.lo), np.log10(args.hi),
                                      args.points),
            num_samples=args.num_samples, maxiter=args.maxiter, **dev,
            **x64)
        if args.plot:
            print(ex.generate_cost_plot(args.dataset))
        return

    print(f"x = {np.asarray(res.x)!r}\ncost = {res.cost}\n"
          f"iterations = {res.iterations}")


if __name__ == "__main__":
    main()
