"""Each test writes its images under a temporary directory of its own, as
each run of the benchmark writes under its own TMPDIR."""

import tempfile

import pytest


@pytest.fixture(autouse=True)
def _own_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
