"""Tiny benchmark roots shared by the harness's CPU tests (tiny.py)."""
import warnings

import pytest

from meshbench.tests.tiny import make_root

warnings.filterwarnings("ignore", message="Sparse CSR tensor support")


@pytest.fixture(scope="session")
def root32(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("fp32")), "float32")


@pytest.fixture(scope="session")
def root16(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bf16")), "bfloat16")
