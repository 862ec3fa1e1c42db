"""The port's dry-run (``python -m repro_torch.launch.dryrun``) in
subprocesses, each tracing one combo on a fake 256-rank process group with
meta-tensor shards: JAX's two integration combos (whisper-tiny ×
decode_32k, mamba2-130m × long_500k) and deepseek-moe-16b × decode_32k
(replicated-token expert parallelism) and × prefill_32k (all-to-all
expert parallelism). Each record: 256 ranks, fits the card, a dominant
term of the three kinds, the analytic FLOPs and bytes equal to
``repro.launch.analysis.analytic_terms``; the MoE combos' collectives
carry their kinds. Then the recorder on a world-1 gloo group: each
collective's bytes recorded under its kind.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMBOS = [("whisper-tiny", "decode_32k"), ("mamba2-130m", "long_500k"),
          ("deepseek-moe-16b", "decode_32k"),
          ("deepseek-moe-16b", "prefill_32k")]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = {}
    for arch, shape in COMBOS:
        out = tmp / f"{arch}_{shape}.json"
        procs[arch, shape] = (out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", str(out)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    recs = {}
    for key, (out, p) in procs.items():
        log = p.communicate(timeout=600)[0]
        assert p.returncode == 0, log[-3000:]
        data = json.loads(out.read_text())
        assert not data["failures"]
        recs[key] = data["records"][0]
    return recs


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_dryrun_single_pod(records, arch, shape):
    rec = records[arch, shape]
    assert rec["n_chips"] == 256 and rec["mesh"] == "single"
    assert rec["fits_hbm"]
    assert rec["compute_s"] >= 0 and rec["memory_s"] > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["coll_breakdown"]["count"] > 0
    assert rec["traced_flops"] > 0


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_dryrun_analytic_terms_equal_jax(records, arch, shape):
    from repro.configs.shapes import cfg_for_shape, shape_for
    from repro.launch.analysis import analytic_terms
    from repro.models.registry import get_config, get_model
    cfg = cfg_for_shape(get_config(arch), shape)
    terms = analytic_terms(cfg, get_model(cfg), shape_for(shape))
    rec = records[arch, shape]
    assert rec["flops_global"] == terms["flops"]
    assert rec["bytes_global"] == terms["bytes"]


def test_moe_collectives_by_branch(records):
    """Prefill (32 × 32768 tokens) takes the all-to-all branch; decode's
    128 tokens the replicated branch, whose expert slices add up in an
    all-reduce over "model"."""
    pre = records["deepseek-moe-16b", "prefill_32k"]["coll_breakdown"]
    dec = records["deepseek-moe-16b", "decode_32k"]["coll_breakdown"]
    assert pre["all-to-all"] > 0
    assert dec["all-to-all"] == 0 and dec["all-reduce"] > 0


@pytest.fixture
def world1():
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_host_group
    assert not dist.is_initialized()
    init_host_group("cpu")
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_recorder_counts_known_bytes(world1):
    import torch.distributed._functional_collectives as fc
    from repro_torch.launch.analysis import collective_bytes
    from repro_torch.launch.dryrun import StepRecorder
    with StepRecorder() as rec:
        fc.all_gather_tensor(torch.ones(3, 5), 0, world1).wait()
        fc.all_to_all_single(torch.ones(4, 2, dtype=torch.int32), None,
                             None, world1).wait()
        fc.all_reduce(torch.ones(7, dtype=torch.bfloat16), "sum",
                      world1).wait()
        torch.ones(2, 3) @ torch.ones(3, 4)
    assert rec.events == [("all-gather", 60), ("all-to-all", 32),
                          ("all-reduce", 14)]
    assert rec.flops == 2 * 2 * 3 * 4
    c = collective_bytes(rec.events)
    assert c["count"] == 3 and c["all-gather"] == 60
    assert c["reduce-scatter"] == 0
