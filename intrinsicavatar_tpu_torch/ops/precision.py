"""Scoped reduced-precision compute (counterpart of the JAX package's
``ops/precision.py``).

Master parameters stay float32; inside ``scope(torch.bfloat16)`` the hash
tables are gathered as bfloat16 rows (kernels KA and KB in their bf16-row
forms) and the ``VanillaMLP`` products take bfloat16 operands with float32
accumulation and a float32 result (``nets/mlp.py``):

    with precision.scope("bfloat16"):
        feat = geometry.features(x)

``scope(None)`` (or ``"float32"``, or no active scope) keeps everything
float32.  The scope is Python state read when an op runs, so a backward run
after the ``with`` block has closed runs in float32, as the JAX package's
custom-VJP backwards do (they are traced at transposition, outside the
scope).
"""

from __future__ import annotations

import contextlib
import weakref

import torch

_STACK: list = []
_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def as_dtype(dtype):
    """``torch.bfloat16`` for ``"bfloat16"`` or ``torch.bfloat16``; None for
    ``"float32"``, ``torch.float32`` or None.  Any other value raises: the
    configs use these two."""
    if dtype is None or dtype is torch.float32:
        return None
    if dtype is torch.bfloat16:
        return dtype
    if isinstance(dtype, str) and dtype in _DTYPES:
        return _DTYPES[dtype]
    raise ValueError(f"compute dtype {dtype!r} is not supported: use "
                     f"'bfloat16' or 'float32'")


def current_dtype():
    """Active compute dtype, or None for full precision."""
    return _STACK[-1] if _STACK else None


@contextlib.contextmanager
def scope(dtype):
    _STACK.append(as_dtype(dtype))
    try:
        yield
    finally:
        _STACK.pop()


def cast_in(x: torch.Tensor) -> torch.Tensor:
    """``x`` in the active compute dtype (unchanged outside a scope)."""
    d = current_dtype()
    return x if d is None or x.dtype == d else x.to(d)


# id(table) -> (weakref to the table, its _version, data_ptr, dtype, cast)
_TABLES: dict = {}


def cast_table(table: torch.Tensor) -> torch.Tensor:
    """The hash table in the active compute dtype, without history: made once
    per version of the table (an optimizer step or a load bumps it), so once
    a frame at eval and once a step in training, not once a call.  The values
    are the per-call cast's (round to nearest even)."""
    d = current_dtype()
    if d is None or table.dtype == d:
        return table
    key = id(table)
    hit = _TABLES.get(key)
    if (hit is not None and hit[0]() is table and hit[1] == table._version
            and hit[2] == table.data_ptr() and hit[3] == d):
        return hit[4]
    low = table.detach().to(d)
    _TABLES[key] = (weakref.ref(table, lambda _: _TABLES.pop(key, None)),
                    table._version, table.data_ptr(), d, low)
    return low
