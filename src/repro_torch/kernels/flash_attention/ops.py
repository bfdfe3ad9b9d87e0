"""Attention entry point of the port (the reference's ``ops.py::mha``).

  impl="naive"   - dense softmax (``ref.attention_ref``), the oracle
  impl="pallas"  - the flash_attention kernel (``kernel.flash_attention``;
                   the name is the reference's, whose kernel is Pallas):
                   on CUDA one of the two hand-written kernels (bf16 on
                   the tensor cores, the rest in f32; ``kernel.route``),
                   on the CPU their plain version
  impl="chunked" - the reference's online softmax in XLA with its custom
                   VJP, the training path: it comes with the training slice

The two implementations align a causal mask differently when ``S != SK``
(bottom-right for "naive", top-left for "pallas"), as the reference's do.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention import ref as _ref


def mha(q, k, v, *, causal: bool = True, scale=None, impl: str = "naive"):
    if impl == "pallas":
        return _k.flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "naive":
        return _ref.attention_ref(q, k, v, causal=causal, scale=scale)
    if impl == "chunked":
        raise NotImplementedError(
            "mha(impl='chunked') is the training path; it comes with the "
            "training slice of the port")
    raise ValueError(f"unknown attention impl {impl!r}")
