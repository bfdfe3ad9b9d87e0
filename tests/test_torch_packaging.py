"""The port's packaging: a non-editable install carries every kernel
source, and the console scripts name real entry points."""
from __future__ import annotations

import fnmatch
import importlib
import pathlib
import tomllib

REPO = pathlib.Path(__file__).resolve().parent.parent
PYPROJECT = tomllib.loads((REPO / "pyproject.toml").read_text())


def test_every_kernel_source_matches_a_package_data_glob():
    data = PYPROJECT["tool"]["setuptools"]["package-data"]
    kernels = REPO / "src" / "repro_torch" / "kernels"
    sources = sorted(p for p in kernels.glob("*/csrc/*") if p.is_file())
    assert sources, "no kernel source found"
    for src in sources:
        pkg = "repro_torch.kernels." + src.parent.parent.name
        rel = src.relative_to(src.parent.parent).as_posix()
        globs = data.get(pkg, [])
        assert any(fnmatch.fnmatch(rel, g) for g in globs), (
            f"{src.relative_to(REPO)} matches no package-data glob of "
            f"{pkg}: {globs}")


def test_console_scripts_name_real_entry_points():
    scripts = PYPROJECT["project"]["scripts"]
    assert scripts["repro-torch-lint"] == "repro_torch.analysis.cli:main"
    for target in scripts.values():
        module, _, attr = target.partition(":")
        assert callable(getattr(importlib.import_module(module), attr))
