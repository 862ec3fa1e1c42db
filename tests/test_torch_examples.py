"""The port's four examples (``repro_torch.examples``: quickstart,
secure_exchange, async_dropout, satqfl_statlog) on the CPU against the
JAX package's: quickstart at its fixed defaults and async_dropout at
small arguments print the lines the JAX scripts print (``examples/*.py``
run in subprocesses, started together with the Table IV loop below while
the port's examples run here), and satqfl_statlog's copy of
``benchmarks.bench_frameworks.run`` gives JAX's table (every metric and
curve within 1e-5) at small arguments; every loss finite, the JSON
written only where ``--out`` says; secure_exchange's BB84 lengths,
QBERs, stream length and tag equal to what ``repro``'s functions give on
the same keys (the OTP kernel's single-stream entry in Pallas interpret
mode), its decryption exact and its one-bit tamper caught; and every
example raises without CUDA unless the CPU is asked for.
"""
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import (async_dropout, quickstart, satqfl_statlog,
                                  secure_exchange)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {"quickstart": quickstart, "secure_exchange": secure_exchange,
            "async_dropout": async_dropout,
            "satqfl_statlog": satqfl_statlog}
AD_ARGS = ["--rounds", "4", "--local-steps", "2"]
T4_ARGS = dict(n_sats=12, n_rounds=2, local_steps=4, qubits=4)

_TABLE4 = """
import json, sys
from benchmarks.bench_frameworks import run
json.dump(run(dataset="statlog", **%r), open(sys.argv[1], "w"))
""" % (T4_ARGS,)


class _JaxRuns:
    """The JAX scripts, each in a subprocess, all started at once."""

    def __init__(self, tmp):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.pathsep.join([os.path.join(REPO, "src"),
                                               REPO]))
        env.pop("XLA_FLAGS", None)
        self.table_path = str(tmp / "table4.json")
        cmds = {"quickstart": [os.path.join(REPO, "examples",
                                            "quickstart.py")],
                "async_dropout": [os.path.join(REPO, "examples",
                                               "async_dropout.py")] + AD_ARGS,
                "table4": ["-c", _TABLE4, self.table_path]}
        self.procs = {k: subprocess.Popen(
            [sys.executable] + c, env=env, cwd=str(tmp), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for k, c in cmds.items()}
        self.done = {}

    def stdout(self, name: str) -> str:
        if name not in self.done:
            out, err = self.procs[name].communicate(timeout=600)
            assert self.procs[name].returncode == 0, err[-3000:]
            self.done[name] = out
        return self.done[name]

    def table(self) -> dict:
        self.stdout("table4")
        with open(self.table_path) as f:
            return json.load(f)

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = _JaxRuns(tmp_path_factory.mktemp("jax_examples"))
    yield runs
    runs.close()


def _printed(lines) -> str:
    return "".join(line + "\n" for line in lines)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_needs_the_card_or_asks_for_the_cpu(name, jax_runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EXAMPLES[name].main([])


def test_quickstart(jax_runs):
    out = quickstart.main(["--device", "cpu"])
    assert out["lines"][0] == "== sat-QFL quickstart =="
    assert out["lines"][-1] == "done."
    assert set(out["metrics"]) == {"sim", "seq", "async"}
    for mode, m in out["metrics"].items():
        assert math.isfinite(m.server_val_loss), mode
        assert any(line.startswith(f"mode={mode:5s} | val_acc=")
                   for line in out["lines"])
    assert _printed(out["lines"]) == jax_runs.stdout("quickstart")


def test_async_dropout(jax_runs):
    out = async_dropout.main(["--device", "cpu"] + AD_ARGS)
    assert list(out["metrics"]) == ["async-v2", "secagg",
                                    "secagg+eavesdrop"]
    for label, m in out["metrics"].items():
        assert math.isfinite(m.server_val_acc), label
        assert f"\n== {label} ==" in out["lines"]
    aborted = [line for line in out["lines"]
               if line.startswith("  QBER-aborted edges")]
    assert aborted[:2] == ["  QBER-aborted edges  : []"] * 2
    assert aborted[2] != aborted[0]       # the eavesdropped edges abort
    assert _printed(out["lines"]) == jax_runs.stdout("async_dropout")


def _assert_close(got, want, where=""):
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        if math.isnan(want):
            assert math.isnan(got), where
        else:
            assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), \
                (where, got, want)
    else:
        assert got == want, where


@pytest.mark.parametrize("write", [False, True], ids=["no-out", "out"])
def test_satqfl_statlog(write, tmp_path, monkeypatch, jax_runs):
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "table4.json"
    argv = ["--device", "cpu", "--sats", str(T4_ARGS["n_sats"]), "--rounds",
            str(T4_ARGS["n_rounds"]), "--local-steps",
            str(T4_ARGS["local_steps"]), "--qubits", str(T4_ARGS["qubits"])]
    out = satqfl_statlog.main(argv + (["--out", str(path)] if write else []))
    table = out["table"]["frameworks"]
    assert list(table) == ["QFL", "QFL-Async", "QFL-Seq", "QFL-Sim"]
    for label, fw in table.items():
        assert math.isfinite(fw["server_val_loss_final"]), label
        assert fw["server_val_loss_final"] < 10
    assert out["lines"][1].startswith("framework")
    _assert_close(out["table"], jax_runs.table())
    if write:
        assert json.loads(path.read_text())["frameworks"].keys() == \
            table.keys()
    else:
        assert list(tmp_path.iterdir()) == []


@pytest.fixture(scope="module")
def jax_secure():
    """JAX's BB84 and single-stream OTP kernel on the example's keys."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import otp_xor_mac
    from repro.models import get_config, get_model
    from repro.quantum import bb84_keygen, derive_pad_seed
    from repro.security import tree_to_u32
    from repro.security.otp import pad_u32
    res = bb84_keygen(jax.random.PRNGKey(0), 512)
    attacked = bb84_keygen(jax.random.PRNGKey(1), 512, eavesdrop=True)
    cfg = get_config("vqc-satqfl")
    params = get_model(cfg).init(cfg, jax.random.PRNGKey(2))
    seed = derive_pad_seed(res.sifted_key, res.key_len)
    stream = tree_to_u32(params)
    _, tag = otp_xor_mac(stream, pad_u32(seed, stream.shape[0]), seed,
                         seed ^ jnp.uint32(0xDEAD))
    return {"key_len": int(res.key_len), "qber": float(res.qber),
            "qber_attacked": float(attacked.qber),
            "n_words": int(stream.shape[0]), "tag": int(tag)}


def test_secure_exchange_equals_jax(jax_secure):
    out = secure_exchange.main(["--device", "cpu"])
    for k, v in jax_secure.items():
        assert out[k] == v, k
    assert out["decrypt_exact"] and out["tamper_detected"]
    assert out["edge_kernel_matches"]
    assert out["fidelity"] == pytest.approx(1.0, abs=1e-5)
    assert out["lines"][0] == "== Algorithm 2: secure model exchange =="
    assert len(out["edge_tags"]) == 8


def test_secure_exchange_runs_as_a_module():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.examples.secure_exchange", "--device",
                        "cpu"], capture_output=True, text=True, env=env,
                       timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "decryption exact: True" in r.stdout
    assert "single-bit tamper detected: True" in r.stdout
