"""PyTorch/CUDA port of the in-network coordination engine.

Imports ``torch`` and numpy only, never JAX and never the ``repro``
package it ports: the two meet in the tests, through numpy
(``repro_torch.convert``).
"""
