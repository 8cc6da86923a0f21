"""Without a card the benchmark fails and prints no result: it never falls
back to the CPU."""

import shutil
import subprocess
import sys
from pathlib import Path

import torch

from portbench import run

REPO = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "vgg16_voc.serve_b4", "--seed", "3", "--seconds", "1", "--trace", "0"]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_cannot_run(tmp_path):
    """A directory with BENCHMARK.json and portbench/ only: no port to run."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench.run", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
