"""Fixtures of the benchmark's tests. Tests that need the card carry the
`cuda` marker and decide inside the test whether a card is there."""

from __future__ import annotations

import os
import shutil

import pytest

from benchmark.tests.tiny import REPO, add_tiny_cells


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the PyTorch port's kernels); skips without one")


@pytest.fixture
def tree(tmp_path):
    """A copy of BENCHMARK.json and benchmark/ with the tiny cells added."""
    root = str(tmp_path / "tree")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cells(root)
    return root


@pytest.fixture
def in_tree(tree, monkeypatch):
    """The harness of this process pointed at `tree`'s files."""
    from benchmark import harness

    monkeypatch.setattr(harness, "ROOT", tree)
    monkeypatch.setattr(harness, "HERE", os.path.join(tree, "benchmark"))
    return tree
