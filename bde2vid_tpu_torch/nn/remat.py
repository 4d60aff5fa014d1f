"""Per-step rematerialisation for training (counterpart of the JAX package's
``nn.remat`` around each scan body, ``bde2vid_tpu/models/bde2vid.py``).

``checkpoint_step`` runs one time step of a sweep under
``torch.utils.checkpoint``: the forward keeps only the step's inputs, and
the backward recomputes the step's activations from them, one step at a
time. A checkpoint of the whole forward would recompute every step at once
and lower no peak.

A recompute must reproduce the forward exactly, and two things of a step
are not functions of its inputs:

- DropPath masks come from an explicit ``torch.Generator``, whose state
  ``torch.utils.checkpoint``'s ``preserve_rng_state`` does not keep. The
  recompute sets the generator back to its state at the step's forward,
  and afterwards to where it was.
- Train-mode BatchNorm/InstanceNorm layers move their running statistics
  once per call. During a recompute ``recomputing()`` is true and they
  leave them alone, so a remat step updates them once, as in the forward.

A row-sharded forward (``parallel.spatial``) is recomputed under the same
row context, so the recompute makes the forward's halo exchanges again.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from bde2vid_tpu_torch.parallel import spatial

_depth = 0  # recomputes in progress


def recomputing() -> bool:
    """True while ``checkpoint_step`` recomputes a step for its backward."""
    return _depth > 0


@contextlib.contextmanager
def _recompute(generator: Optional[torch.Generator], state: Optional[torch.Tensor], rows):
    global _depth
    now = None if generator is None else generator.get_state()
    if generator is not None:
        generator.set_state(state)
    _depth += 1
    try:
        with spatial.entered(rows):
            yield
    finally:
        _depth -= 1
        if generator is not None:
            generator.set_state(now)


def checkpoint_step(fn: Callable, *args, generator: Optional[torch.Generator] = None):
    """``fn(*args)``, rematerialised in the backward. ``generator``: the
    DropPath generator ``fn`` draws from, if any."""
    state = None if generator is None else generator.get_state()
    rows = spatial.current()
    return checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute(generator, state, rows)),
    )
