"""Boundaries of the PyTorch port: what it may import, where it runs."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.constellation import build_trace, walker_constellation
from repro_torch.core import SatQFLTrainer
from repro_torch.data import make_statlog
from repro_torch.device import resolve_device
from repro_torch.models import get_config
from repro_torch.prng import PRNGKey

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_default_device_raises_without_cuda(monkeypatch):
    """Entry points default to CUDA and never drop to the CPU on their own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (resolve_device, lambda: resolve_device("cuda"),
                 lambda: PRNGKey(0), lambda: make_statlog(),
                 lambda: build_trace(n_sats=4, n_planes=2, duration_s=60),
                 lambda: walker_constellation(4, 2),
                 lambda: SatQFLTrainer(get_config("vqc-satqfl"), None,
                                       None, None, [], {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
