"""Dataset synthesis (bpldenoising_tpu_torch/data/generate.py) against the
JAX package's data/generate.py: every random draw comes from
``np.random.default_rng``, so the same seeds give the same bits.  The
written datasets go to ``tmp_path`` (never into ``datasets/``) and decode
to the JAX package's arrays; the refusals match tests/test_generate.py."""

import os

import numpy as np
import pytest

from bpldenoising_tpu.data import generate as jgen
from bpldenoising_tpu.data import load_dataset as j_load
from bpldenoising_tpu_torch.data import generate as tgen
from bpldenoising_tpu_torch.data import datasets as tdatasets
from bpldenoising_tpu_torch.data import load_dataset as t_load


@pytest.mark.parametrize("fn,args", [
    ("circle_phantom", dict(size=33, radius=0.25, center=(0.4, 0.6),
                            intensity=0.8)),
    ("affine_phantom", dict(size=20, kind="ramp")),
    ("affine_phantom", dict(size=20, kind="pyramid")),
    ("affine_phantom", dict(size=20, kind="facets", seed=5)),
    ("color_phantom", dict(size=24, kind="disks")),
    ("color_phantom", dict(size=24, kind="squares", seed=3))],
    ids=["circle", "ramp", "pyramid", "facets", "disks", "squares"])
def test_phantoms_bit_equal(fn, args):
    got = getattr(tgen, fn)(**args)
    want = getattr(jgen, fn)(**args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("fn,arg", [("add_noise", 0.1),
                                    ("add_impulse_noise", 0.2)])
@pytest.mark.parametrize("rng", [7, "generator"])
def test_noise_bit_equal(fn, arg, rng):
    img = jgen.circle_phantom(24)
    draw = (lambda: np.random.default_rng(11)) if rng == "generator" \
        else (lambda: rng)
    assert np.array_equal(getattr(tgen, fn)(img, arg, draw()),
                          getattr(jgen, fn)(img, arg, draw()))


@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
def test_make_dataset_decodes_to_the_jax_arrays(tmp_path, color):
    imgs = ([tgen.color_phantom(16), tgen.color_phantom(16, "squares", 2)]
            if color else [tgen.circle_phantom(16), tgen.affine_phantom(16)])
    ours = tgen.make_dataset("gen_16_10", imgs, sigma=0.1, seed=4,
                             out_root=str(tmp_path / "port"))
    theirs = jgen.make_dataset("gen_16_10", imgs, sigma=0.1, seed=4,
                               out_root=str(tmp_path / "jax"))
    with open(os.path.join(ours, "filelist.txt")) as a, \
            open(os.path.join(theirs, "filelist.txt")) as b:
        assert a.read() == b.read()
    for g, w in zip(t_load(ours, color=color), j_load(theirs, color=color)):
        assert np.array_equal(g, w)
    assert "gen_16_10" not in tdatasets.remotedatasets  # not in dataset_dir


def test_make_dataset_registers_under_the_jax_rule(tmp_path, monkeypatch):
    """A dataset written into dataset_dir is appended to remotedatasets
    and resolves by prefix; explicit pairs and every refusal as in the JAX
    package."""
    monkeypatch.setattr(tdatasets, "dataset_dir", str(tmp_path))
    monkeypatch.setattr(tdatasets, "remotedatasets",
                        list(tdatasets.remotedatasets))
    tgen.make_dataset("tmpgen_8_0", [np.zeros((8, 8))],
                      noisy_images=[np.full((8, 8), 0.25)])
    assert "tmpgen_8_0" in tdatasets.remotedatasets
    tru, noisy = tdatasets.testdataset("tmpgen")
    assert tru.shape == (1, 8, 8) and np.all(noisy == 64 / 255)
    bad = [(dict(true_images=[]), "empty"),
           (dict(true_images=[np.zeros((2, 2, 2))]), r"planar \(3, M, N\)"),
           (dict(true_images=[np.zeros((1, 2, 2, 2))]), "2-D"),
           (dict(true_images=[np.full((4, 4), 2.0)]), r"\[0, 1\]"),
           (dict(true_images=[np.zeros((8, 8))],
                 noisy_images=[np.zeros((4, 4))]), "mismatch"),
           (dict(true_images=[np.zeros((8, 8))], noisy_images=[]), "noisy")]
    for kw, match in bad:
        with pytest.raises(ValueError, match=match):
            tgen.make_dataset("x", out_root=str(tmp_path), **kw)
        with pytest.raises(ValueError, match=match):
            jgen.make_dataset("x", out_root=str(tmp_path), **kw)
    for fn, kw in (("circle_phantom", dict(size=0)),
                   ("affine_phantom", dict(kind="cone")),
                   ("color_phantom", dict(kind="stripes"))):
        with pytest.raises(ValueError):
            getattr(tgen, fn)(**kw)
