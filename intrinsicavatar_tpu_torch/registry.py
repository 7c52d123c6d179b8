"""Name-keyed component registry of the port, separate from the JAX
package's so that names such as ``volume-sdf`` do not collide."""

from __future__ import annotations

from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str):
    """Class decorator registering a component under ``name``."""

    def decorator(cls):
        if name in _REGISTRY and _REGISTRY[name] is not cls:
            raise ValueError(f"duplicate registry name: {name!r}")
        _REGISTRY[name] = cls
        cls.registry_name = name
        return cls

    return decorator


def make(name: str, config=None, **kwargs):
    """Construct the component registered under ``name``."""
    _populate()
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown component {name!r} in this slice of the port; "
            f"known: {sorted(_REGISTRY)}")
    if config is None:
        return _REGISTRY[name](**kwargs)
    return _REGISTRY[name](config, **kwargs)


_POPULATED = False


def _populate():
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    import intrinsicavatar_tpu_torch.fields.geometry  # noqa: F401
    import intrinsicavatar_tpu_torch.fields.radiance  # noqa: F401
    import intrinsicavatar_tpu_torch.fields.density  # noqa: F401
    import intrinsicavatar_tpu_torch.fields.material  # noqa: F401
    import intrinsicavatar_tpu_torch.pbr.brdf  # noqa: F401
    import intrinsicavatar_tpu_torch.pbr.envlight  # noqa: F401
    import intrinsicavatar_tpu_torch.anim.pose  # noqa: F401
    import intrinsicavatar_tpu_torch.anim.deformer  # noqa: F401
    import intrinsicavatar_tpu_torch.anim.non_rigid  # noqa: F401
    import intrinsicavatar_tpu_torch.render.renderer  # noqa: F401
