"""The draws of a step that follow the batch's rows.

Every draw of one value per batch element is made here: :func:`randn`
(latent noise), :func:`bernoulli` (dropout masks) and
:func:`element_offset` (the first Philox counter of the ELU+dropout
kernel, which keys its bits by the flat element index).  They are plain
torch draws, unless the batch in hand is one part of a larger batch
(:func:`batch_rows`: under data parallelism, ``parallel/mesh.py:
batch_shard`` enters it with the rank's part of the global batch).  Then
each draw is made at the whole batch's rows from a generator seeded alike
on every part, and the part keeps its rows; the offset is the part's first
element in the whole tensor.  So N ranks draw what one process draws for
the joined batch.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

# (index, count) while the batch in hand is part ``index`` of ``count``
# equal parts of a batch (split on dim 0).
_part: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def batch_rows(index: int, count: int):
    """Within: the batch in hand is part ``index`` of ``count`` equal parts
    of the batch, and the draws follow it."""
    global _part
    old = _part
    _part = (index, count)
    try:
        yield
    finally:
        _part = old


def _rows(draw, shape):
    if _part is None or _part[1] == 1:
        return draw(tuple(shape))
    index, count = _part
    rows = shape[0]
    full = draw((count * rows,) + tuple(shape[1:]))
    return full[index * rows:(index + 1) * rows]


def randn(shape, generator=None, device=None, dtype=None) -> torch.Tensor:
    """``torch.randn(shape)``; inside :func:`batch_rows` the part's rows
    (dim 0) of the whole batch's draw."""
    return _rows(lambda s: torch.randn(s, generator=generator,
                                       device=device, dtype=dtype), shape)


def bernoulli(like: torch.Tensor, p: float, generator=None) -> torch.Tensor:
    """A 0/1 mask shaped like ``like`` (keep probability p), rows drawn as
    :func:`randn`'s."""
    return _rows(lambda s: like.new_empty(s).bernoulli_(
        p, generator=generator), like.shape)


def element_offset(n_local: int) -> int:
    """The flat index of the part's first element in the whole tensor of
    which it holds ``n_local`` elements (0 outside :func:`batch_rows`)."""
    if _part is None:
        return 0
    return _part[0] * n_local
