"""The PyTorch port's ``serve`` and ``warmup`` commands on the CPU:
``serve`` in-process with a scripted stdin of tiny ``scaled`` runs, plain
and JSON requests, bad requests, a failing run, a nested ``serve``,
``quit`` and end of input; ``warmup`` with the kernel build and the
workloads replaced, to see what it calls."""

import io
import json

import pytest
import torch

from gp_bayesopinf_torch.ops import build as build_module
from gp_bayesopinf_torch.pipeline import cli, experiments
from gp_bayesopinf_torch.utils import device as device_module

TINY = ("scaled --n-space 48 --k 80 --modes 2 --gp-samples 30 --mprime 32 --restarts 2 "
        "--ndraws 4 --grid-size 4 --device cpu --quiet")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _serve(monkeypatch, capsys, lines):
    """Run ``serve`` on ``lines``; returns (exit code, acks, other stdout lines)."""
    monkeypatch.setattr("sys.stdin", io.StringIO("".join(line + "\n" for line in lines)))
    rc = cli.main(["serve"])
    out = capsys.readouterr().out.splitlines()
    acks = [json.loads(line)["serve"] for line in out if line.startswith('{"serve"')]
    for ack in acks:
        assert {"rc", "wall_s", "argv", "launches"} <= set(ack), ack
        assert isinstance(ack["wall_s"], float) and ack["wall_s"] >= 0.0
    return rc, acks, [line for line in out if not line.startswith('{"serve"')]


def test_serve_answers_and_survives(monkeypatch, capsys):
    rc, acks, out = _serve(monkeypatch, capsys, [
        "# a comment, then a blank line",
        "",
        TINY,
        json.dumps({"argv": TINY.split()}),
        "42",
        '{"x": 1}',
        '"scaled"',
        "[]",
        "euler 0.06",
        TINY + " --windows 2 --window-basis local",
        "serve",
        "quit",
        TINY,  # after quit: not run
    ])
    assert rc == 0
    assert [a["rc"] for a in acks] == [0, 0, 2, 2, 2, 2, 2, 1, 2]
    assert acks[0]["argv"] == acks[1]["argv"] == TINY.split()
    # The CPU takes the screens' plain versions: no kernel launches.
    assert acks[0]["launches"] == {"quadratic_ensemble_screen": 0, "cahbn_ensemble_screen": 0}
    for ack in acks[2:6]:
        assert ack["argv"] is None and ack["error"].startswith("bad request")
    assert "argparse" in acks[6]["error"] and acks[6]["argv"] == ["euler", "0.06"]
    assert "NotImplementedError" in acks[7]["error"]
    assert "nest" in acks[8]["error"] and acks[8]["argv"] == ["serve"]
    summaries = [json.loads(line) for line in out if line.startswith('{"regularizer"')]
    assert len(summaries) == 2 and summaries[0] == summaries[1]


def test_serve_ends_at_end_of_input(monkeypatch, capsys):
    rc, acks, _ = _serve(monkeypatch, capsys, ["exit", "serve"])
    assert rc == 0 and acks == []
    rc, acks, _ = _serve(monkeypatch, capsys, ["seird 90", "   "])
    assert rc == 0 and [a["rc"] for a in acks] == [2]


def test_warmup_builds_then_runs(monkeypatch, capsys, tmp_path):
    """On a CUDA device ``warmup`` builds both kernel libraries first and
    prints their paths, then runs each named flagship workload with the
    given draws on that device; on the CPU it builds nothing."""
    calls = []

    class Info:
        def __init__(self, name):
            self.path, self.seconds = tmp_path / f"lib{name}.so", 0.0 if "cahbn" in name else 2.5

    def fake_build(name):
        calls.append(("build", name))
        return Info(name)

    def fake_workload(pipeline, name, ndraws=600, *, device, **kw):
        calls.append(("run", pipeline, name, ndraws, str(device), kw.get("verbose")))

    monkeypatch.setattr(build_module, "build", fake_build)
    monkeypatch.setattr(experiments, "run_workload", fake_workload)
    monkeypatch.setattr(device_module, "resolve_device", lambda device: torch.device(device))
    assert cli.main(["warmup", "seird", "heat", "--ndraws", "7"]) == 0
    assert sorted(calls[:2]) == [("build", "cahbn_screen"), ("build", "quadratic_screen")]
    assert calls[2:] == [("run", "seird", "ex1a", 7, "cuda", False),
                         ("run", "heat", "ex3", 7, "cuda", False)]
    out = capsys.readouterr().out
    assert f"{tmp_path / 'libquadratic_screen.so'} built in 2.5 s" in out
    assert f"{tmp_path / 'libcahbn_screen.so'} already built" in out

    calls.clear()
    assert cli.main(["warmup", "--device", "cpu"]) == 0
    assert calls == [("run", p, w, 600, "cpu", False)
                     for p, w in (("seird", "ex1a"), ("euler", "ex1a"), ("heat", "ex3"))]
    args = cli.build_parser().parse_args(["warmup"])
    assert (args.pipelines, args.ndraws, args.device) == ([], 600, "cuda")
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["warmup", "scaled"])


def test_warmup_through_serve(monkeypatch, capsys):
    runs = []
    monkeypatch.setattr(experiments, "run_workload",
                        lambda pipeline, name, ndraws=600, *, device, **kw: runs.append(ndraws))
    rc, acks, out = _serve(monkeypatch, capsys, ["warmup seird --ndraws 5 --device cpu"])
    assert rc == 0 and [a["rc"] for a in acks] == [0] and runs == [5]
    assert any(line.startswith("[warmup] seird done in") for line in out)


def test_run_and_main_contract(monkeypatch):
    """``run`` returns the result and refuses the commands that are not
    runs; ``main`` returns an int, the console script's exit code."""
    res = cli.run(TINY.split())
    assert res.num_modes == 2 and res.ensemble_mean.shape == (2, 32)
    for command in ("serve", "warmup"):
        with pytest.raises(ValueError, match="not a pipeline run"):
            cli.run([command])
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    rc = cli.main(["serve"])
    assert isinstance(rc, int) and rc == 0
