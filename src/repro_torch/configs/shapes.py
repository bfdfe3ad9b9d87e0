"""Input-shape suites assigned to the LM-family architectures (the port's copy
of ``repro/configs/shapes.py``).

Each (arch x shape) pair is one dry-run cell.  ``train_*`` lowers
``train_step``; ``prefill_*`` lowers the prefill ``serve_step``;
``decode_*`` / ``long_*`` lower the one-token ``serve_step`` with a KV
cache of the given length.

Applicability rules (assignment + DESIGN.md §5):
  * long_500k needs sub-quadratic sequence mixing -> SSM/hybrid only.
  * all assigned archs are decoder-bearing, so decode shapes always apply.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SHAPE_IDS = list(SHAPES)


def applicable(cfg: ArchConfig, shape_id: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped)."""
    if shape_id == "long_500k" and not cfg.supports_long_context:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip per assignment rule)"
        )
    return True, ""


def cells(archs: list[str] | None = None):
    """Yield every applicable (arch_id, shape_id) dry-run cell."""
    from repro_torch.configs.base import ARCH_IDS, get_config

    for arch_id in archs or ARCH_IDS:
        cfg = get_config(arch_id)
        for shape_id in SHAPE_IDS:
            ok, _ = applicable(cfg, shape_id)
            if ok:
                yield arch_id, shape_id
