"""Golden provenance: tests/tools/make_golden.py --check must
reproduce every committed tests/data/ref_* file byte-for-byte from a
reference-binary build. Skips when no
reference build is present (CI ships pre-generated goldens)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_BIN = "/tmp/refbuild/minialign"


@pytest.mark.slow
def test_goldens_reproduce_from_reference():
    if not os.path.exists(REF_BIN):
        pytest.skip("no reference build at /tmp/refbuild (see "
                    "tests/tools/make_golden.py to create one)")
    r = subprocess.run(
        [sys.executable,
         os.path.join(ROOT, "tests", "tools", "make_golden.py"),
         REF_BIN, "--check"],
        capture_output=True, timeout=1800)
    assert r.returncode == 0, (r.stdout.decode()[-2000:]
                               + r.stderr.decode()[-500:])
