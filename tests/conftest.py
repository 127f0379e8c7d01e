"""Shared fixtures for the compiler test suite.

The conformance matrix (tests/test_npec_conformance.py) and the MoE
dispatch property tests share ONE pair of tolerance constants so every
family is held to the same bar: float-mode streams must match their jnp
reference to FLOAT_TOL (op-for-op the streams are bitwise faithful; the
slack covers platforms whose BLAS orders reductions differently), and
NPE-mode streams (int8/int16 MMU + PWL NVU on both sides) to NPE_TOL —
the same gates tests/test_npec_decode.py applies to decode rollouts.
"""
import json
import sys
from pathlib import Path

import pytest

FLOAT_TOL = 1e-6
NPE_TOL = 5e-3

RESULTS_DIR = Path(__file__).resolve().parent.parent / "results"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def assert_cycle_record(filename: str, schema: str, rows_fn_name: str):
    """Shared bit-exact guard for the committed compiler cycle records
    (results/*.json): recompute `benchmarks.paper_tables.<rows_fn_name>()`
    and require equality with the record — the cost model is
    deterministic, so any drift means the compiler changed and the record
    must be regenerated via `python -m benchmarks.run`."""
    root = RESULTS_DIR.parent
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))       # benchmarks/ lives at root
    import benchmarks.paper_tables as pt

    record = json.loads((RESULTS_DIR / filename).read_text())
    assert record["schema"] == schema
    got = getattr(pt, rows_fn_name)()
    assert got == record["rows"], (
        f"cycle model drifted from results/{filename} — regenerate with "
        "`python -m benchmarks.run` if the change is intentional")


@pytest.fixture
def float_tol() -> float:
    """Float-mode max-abs tolerance for compiled stream vs jnp reference."""
    return FLOAT_TOL


@pytest.fixture
def npe_tol() -> float:
    """NPE-mode (quantized MMU + PWL NVU) max-abs tolerance."""
    return NPE_TOL


@pytest.fixture
def tol_for():
    """Map a conformance mode name ("float" | "npe") to its tolerance."""
    def _tol(mode: str) -> float:
        return NPE_TOL if mode.startswith("npe") else FLOAT_TOL
    return _tol


@pytest.fixture(scope="session")
def npe_hw():
    """The default overlay the compiler suites target (VRWIDTH 1024)."""
    from repro.core.overlay import NPEHardware
    return NPEHardware(vrwidth=1024)
