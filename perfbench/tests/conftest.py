"""The benchmark's tests: run from the repository's root, as
``python -m pytest perfbench/tests -q``."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(directory, BENCHMARK.json dict) of a copy with the tiny cells."""
    import os

    from perfbench.tests.tiny import tiny_copy

    base = tmp_path_factory.mktemp("perfbench_tiny")
    os.environ.setdefault("TMAT_TORCH_BUILD_DIR", str(base / "build"))
    os.environ.setdefault("TMAT_TPU_BASE_DIR", str(base / "base"))
    return base, tiny_copy(base)
