"""Config / parameter system (counterpart of
``bpldenoising_tpu.utils.config``): a frozen, attribute-accessible mapping
(:class:`Params`) plus a right-biased :func:`merge`, mirroring the
reference's ``default_params ⬿ bilevel_params ⬿ kwargs``.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping


class Params(Mapping[str, Any]):
    """Immutable attribute-accessible parameter bag.

    ``Params(a=1) | Params(a=2, b=3)`` is right-biased merge, mirroring the
    reference's ``⬿`` (NamedTuple override-merge).
    """

    __slots__ = ("_d",)

    def __init__(self, *maps: Mapping[str, Any], **kwargs: Any):
        d: dict[str, Any] = {}
        for m in maps:
            d.update(dict(m))
        d.update(kwargs)
        object.__setattr__(self, "_d", d)

    # Mapping protocol -----------------------------------------------------
    def __getitem__(self, k: str) -> Any:
        return self._d[k]

    def __iter__(self) -> Iterator[str]:
        return iter(self._d)

    def __len__(self) -> int:
        return len(self._d)

    # Attribute access -----------------------------------------------------
    def __getattr__(self, k: str) -> Any:
        try:
            return self._d[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k: str, v: Any):
        raise AttributeError("Params is immutable; use merge / |")

    # Merge ----------------------------------------------------------------
    def __or__(self, other: Mapping[str, Any] | None) -> "Params":
        if other is None:
            return self
        return Params(self._d, dict(other))

    def __ror__(self, other: Mapping[str, Any] | None) -> "Params":
        if other is None:
            return self
        return Params(dict(other), self._d)

    def replace(self, **kwargs: Any) -> "Params":
        return Params(self._d, kwargs)

    def get(self, k: str, default: Any = None) -> Any:
        return self._d.get(k, default)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self._d.items())
        return f"Params({inner})"


def merge(*maps: Mapping[str, Any] | None, **kwargs: Any) -> Params:
    """Right-biased merge of parameter mappings (later wins), like ``⬿``."""
    out = Params()
    for m in maps:
        if m is not None:
            out = out | m
    if kwargs:
        out = out | kwargs
    return out


def check_backend(backend) -> None:
    """The port's rule for the JAX package's ``backend=`` knob, in every
    family's entry points and learning functions: ``"auto"`` (the JAX
    default) is accepted; any other value raises, since ``device=`` chooses
    what runs (``"cuda"``: the CUDA kernels, ``"cpu"``: their plain
    versions)."""
    if backend != "auto":
        raise NotImplementedError(
            f"backend={backend!r} is not ported: the port has no backends; "
            "device='cuda' runs the CUDA kernels and device='cpu' their "
            "plain versions")
