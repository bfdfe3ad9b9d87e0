"""The examples' torch twins against the JAX examples, on the CPU.

Each twin's ``main(["--device", "cpu"])`` and its JAX example's
``main()`` run in this process and print the same lines: every tick,
packet and reply count, stored value, suspected-node list, epoch and
recovery log equal.  Only wall-clock numbers may differ: a number
followed by ``s``, ``ms`` or `` tok/s`` (``WALL_CLOCK``), which only
kv_serving prints (its serving time, rate and latency percentiles).
train_lm's lines also carry what is particular to a run
(``RUN_SPECIFIC``): its step times, each with the straggler flag read
from it (on either run, both or neither), a fresh temporary checkpoint
directory, and its losses, which differ because the two packages draw
their random weights from different generators; both runs must lower
their loss.  It runs 40 steps here
(``ARGV``; the JAX example reads ``sys.argv``).  With no ``--device`` a
twin runs on CUDA, and with no card it raises.
"""
import importlib.util
import pathlib
import re
import sys

import pytest

torch = pytest.importorskip("torch")

import torch_parity  # noqa: E402,F401  (one intra-op thread a worker)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
# a wall-clock number: seconds, milliseconds or tokens per second
WALL_CLOCK = re.compile(r"[\d,]+(\.\d+)?(?=(s|ms| tok/s)\b)")
# how many wall-clock numbers each example prints
WALL_NUMBERS = {"quickstart": 0, "fault_tolerance": 0, "kv_serving": 4,
                "train_lm": 0}
ARGV = {"train_lm": ["--steps", "40"]}
RUN_SPECIFIC = {"train_lm": re.compile(
    r"(?<=loss )\d+\.\d+|(?<=from )\d+\.\d+|(?<=checkpoints -> )\S+"
    r"|\(\d+ ms\)( STRAGGLER)?")}
LOSS = re.compile(r"(?<=loss )\d+\.\d+")


def _module(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys, run) -> list[str]:
    capsys.readouterr()
    run()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", list(WALL_NUMBERS))
def test_twin_prints_the_jax_examples_lines(name, capsys, monkeypatch):
    argv = ARGV.get(name, [])
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    exp = _lines(capsys, _module(name).main)
    got = _lines(capsys, lambda: _module(f"{name}_torch").main(
        [*argv, "--device", "cpu"]))
    assert len(got) == len(exp) and len(exp) > 3
    if name in RUN_SPECIFIC:
        for lines in (got, exp):
            losses = [float(x) for line in lines for x in LOSS.findall(line)]
            assert losses[-1] < losses[0], losses
        got, exp = ([RUN_SPECIFIC[name].sub("<run>", x) for x in lines]
                    for lines in (got, exp))
    masked = []
    for g, e in zip(got, exp):
        (gm, gn), (em, en) = (WALL_CLOCK.subn("<wall>", x) for x in (g, e))
        assert gn == en, (g, e)
        masked.append(gn)
        assert gm == em, (g, e)
    assert sum(masked) == WALL_NUMBERS[name]


@pytest.mark.parametrize("name", list(WALL_NUMBERS))
def test_twin_defaults_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default does not raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        _module(f"{name}_torch").main([])
