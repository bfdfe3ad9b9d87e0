"""The rule catalogue; importing this package registers RL003-RL005.

The JAX package's linter has two more rules, and they are not ported:

* RL001 checks buffer donation (``donate_argnums``): a caller must rebind
  what it donated.  torch has no donation; the port's engine updates its
  state in place and says so (``state = sim.tick(state, inj)``).
* RL002 checks arrays closed over by jitted code, which ``jax.jit`` bakes
  into the executable as constants.  In torch that means something only
  once a CUDA graph captures the port's code, and none does yet.

So ``--rules RL001`` names an unknown id and exits 2.
"""
from __future__ import annotations

from . import rl003, rl004, rl005  # noqa: F401

__all__ = ["rl003", "rl004", "rl005"]
