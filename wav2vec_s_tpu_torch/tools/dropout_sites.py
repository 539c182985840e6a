"""A ``DropoutContext`` that records what a training forward drew.

The card checks hold K4 (``hw_dropout``) against its twin at every
(shape, dtype, rate) that a training path dropped, count the encoder layers
that layerdrop kept, and read the contexts of a run's updates.  Patch the
class in where the path builds its contexts, for example::

    sites = set()
    with mock.patch.object(recipes, "DropoutContext",
                           recording_context(sites)):
        cli.main(argv)
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple, Type

from wav2vec_s_tpu_torch.ops.dropout import DropoutContext

#: (shape, dtype, rate), with ``index=True`` also the site's index map
Site = Tuple


def recording_context(sites: Optional[Set[Site]] = None,
                      kept: Optional[List[int]] = None,
                      contexts: Optional[list] = None,
                      index: bool = False) -> Type[DropoutContext]:
    """A ``DropoutContext`` subclass whose instances add each dropout
    site's (shape, dtype, rate) with rate > 0 to ``sites`` (``index``:
    (shape, dtype, rate, index map), the map that places a shard's
    elements in the whole tensor), append the count of the layers that
    layerdrop kept to ``kept`` (one entry per context) and append
    themselves to ``contexts``; None records nothing of that kind."""

    class Recorded(DropoutContext):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if kept is not None:
                kept.append(0)
            if contexts is not None:
                contexts.append(self)

        def layer_dropped(self, p):
            dropped = super().layer_dropped(p)
            if kept is not None:
                kept[-1] += not dropped
            return dropped

        def __call__(self, x, rate, seq=None):
            if rate and sites is not None:
                site = (tuple(x.shape), x.dtype, rate)
                if index:
                    site += (self.index(tuple(x.shape), seq),)
                sites.add(site)
            return super().__call__(x, rate, seq)

    return Recorded
