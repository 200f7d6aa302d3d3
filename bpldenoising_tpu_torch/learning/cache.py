"""What the learning-function factories share: the dataset's tensors on
the device, and the bounded cache of warm-start states.

The cache holds each state beside its dataset anchor (``ds[0]`` as the
caller passed it) and gives it back only for that very object: the key
carries the anchor's ``id``, and the entry holds the anchor strongly, so
no other tensor can take that ``id`` while the entry lives (a tensor's
``data_ptr()``, which a freed tensor's successor can reuse, is never part
of a key).  The oldest entries go first once the cache is full, so a
long-lived factory does not pin device memory per dataset.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from ..utils.telemetry import record_adjoint_cg

__all__ = ["WarmCache", "dataset_tensors", "make_smoothed_factory"]


class WarmCache:
    """Bounded map (key, anchor) → state."""

    def __init__(self, max_entries: int):
        self.max_entries = int(max_entries)
        self._entries: OrderedDict = OrderedDict()

    @staticmethod
    def key(tag, x, ds) -> tuple:
        """The key of a state: its tag, the parameter's and the dataset's
        shapes and the anchor's identity."""
        return (tag, tuple(getattr(x, "shape", ())), tuple(ds[0].shape),
                id(ds[0]))

    def get(self, key, anchor):
        entry = self._entries.get(key)
        return entry[0] if entry is not None and entry[1] is anchor else None

    def put(self, key, value, anchor) -> None:
        self._entries[key] = (value, anchor)
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def __len__(self):
        return len(self._entries)


def dataset_tensors(ds, device, image_ndim: int = 2):
    """``(true_images, noisy_images)`` → ``(utrue, f, squeeze)``: both on
    ``device`` in the dtype of the true images, contiguous, with a batch
    axis added when a single image (``image_ndim`` axes) was given."""
    utrue = torch.as_tensor(ds[0]).to(device)
    f = torch.as_tensor(ds[1]).to(device=device, dtype=utrue.dtype)
    squeeze = f.ndim == image_ndim
    if squeeze:
        utrue, f = utrue[None], f[None]
    return utrue.contiguous(), f.contiguous(), squeeze


def make_smoothed_factory(fn, *, carry_adjoint: bool, **defaults):
    """The factory of a smoothed family (TGV², TV-L1, VTV): bind
    ``defaults`` to ``fn`` and return the bare contract ``f(x, ds, Δ)``.

    When ``tol`` (the inner early stop) is set, the closure chains the
    inner solver's state across evaluations; with ``carry_adjoint`` it
    also chains the adjoint CG's ``p`` always (TV-L1).  States are kept per
    dataset (8 entries).  ``fn(..., return_aux=True)`` returns
    ``(u, cost, grad[, p], state, info)``; ``lf.adjoint_cg`` and
    ``lf.last_adjoint_cg`` report the adjoint solves."""
    cache = WarmCache(8)

    def lf(x, ds, delta, **overrides):
        kw = dict(defaults)
        kw.update(overrides)
        anchor = ds[0]
        key_p = cache.key("adj", x, ds)
        key_s = cache.key("state", x, ds)
        warm = kw.get("tol") is not None
        if carry_adjoint:
            kw["p0"] = cache.get(key_p, anchor)
        out = fn(x, ds, delta, s0=cache.get(key_s, anchor) if warm else None,
                 return_aux=True, **kw)
        u, cost, grad, state, info = out[:3] + out[-2:]
        if carry_adjoint:
            cache.put(key_p, out[3], anchor)
        if warm:
            cache.put(key_s, state, anchor)
        record_adjoint_cg(lf, info)
        return u, cost, grad

    lf.cache = cache
    return lf
