"""Dataset registry of the port: ``synthetic`` (generated poses, procedural
targets), ``synthetic-image`` (the sphere-traced capsule body's images
with GT masks, albedo and normals), and the real-data loaders
``peoplesnapshot``, ``synthetichuman``, ``rana`` and ``animation``."""

_DATASETS = {}


def register(name):
    def deco(cls):
        _DATASETS[name] = cls
        return cls
    return deco


def make(name, config, **kwargs):
    import intrinsicavatar_tpu_torch.data.animation  # noqa: F401
    import intrinsicavatar_tpu_torch.data.capsule  # noqa: F401
    import intrinsicavatar_tpu_torch.data.peoplesnapshot  # noqa: F401
    import intrinsicavatar_tpu_torch.data.synthetic  # noqa: F401
    import intrinsicavatar_tpu_torch.data.synthetichuman  # noqa: F401
    if name not in _DATASETS:
        raise KeyError(f"dataset {name!r} is not ported yet; the port has "
                       f"{sorted(_DATASETS)}")
    return _DATASETS[name](config, **kwargs)
