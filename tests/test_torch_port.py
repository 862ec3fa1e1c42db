"""Boundaries of the PyTorch port: what it may import, where it runs."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.constellation import build_trace, walker_constellation
from repro_torch.convert import params_from_jax, params_to_numpy
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


def test_convert_carries_bf16_leaves_both_ways():
    """A bfloat16 JAX leaf (an ml_dtypes array under numpy) crosses as its
    bit pattern, and comes back as the same bfloat16 array."""
    jnp = pytest.importorskip("jax.numpy")
    import numpy as np
    x = jnp.asarray([[1.0, -2.5, 3.1415926], [1e-3, 65504.0, -0.0]],
                    jnp.bfloat16)
    t = params_from_jax({"w": np.asarray(x)}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    assert torch.equal(t.float(), torch.tensor(np.asarray(x, np.float32)))
    back = params_to_numpy({"w": t})["w"]
    assert back.dtype == np.asarray(x).dtype
    np.testing.assert_array_equal(back.view(np.int16),
                                  np.asarray(x).view(np.int16))


def test_convert_carries_a_tree_with_a_segment_list():
    """The decoder's tree: a list of per-segment dicts beside top leaves,
    with mixed dtypes; round trip keeps structure, dtypes and values."""
    import numpy as np
    tree = {"embed": np.arange(6, dtype=np.float32).reshape(3, 2),
            "segments": [{"attn": {"wq": np.ones((2, 4, 4), np.float32)},
                          "ln1": np.full((2, 4), 0.5, np.float32)},
                         {"ssm": {"A_log": np.zeros((1, 3), np.float32),
                                  "pos": np.arange(3, dtype=np.int32)}}]}
    t = params_from_jax(tree, device="cpu")
    assert isinstance(t["segments"], list) and len(t["segments"]) == 2
    assert t["segments"][1]["ssm"]["pos"].dtype == torch.int32
    back = params_to_numpy(t)
    assert list(back) == ["embed", "segments"]
    for a, b in ((back["embed"], tree["embed"]),
                 (back["segments"][0]["attn"]["wq"],
                  tree["segments"][0]["attn"]["wq"]),
                 (back["segments"][1]["ssm"]["pos"],
                  tree["segments"][1]["ssm"]["pos"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
