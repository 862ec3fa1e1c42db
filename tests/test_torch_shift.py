"""The port's parameter-shift rule vs the JAX package's (ROADMAP item 9).

``parameter_shift_grad`` at nq=4, L=2, as a single model and over a
client axis (K=3, B=6, the JAX rule vmapped over clients as the batched
executor runs it), with chunk 0 and 3 and with ``with_loss``: ≤ 1e-6 of
the JAX rule. The serial rule ≤ 1e-6 of the JAX serial rule; the shift
rule ≤ 2e-5 of the port's autodiff (the JAX package's own contract). The
launch plan of the rule (which kernel each branch insertion and suffix
layer runs, and how often) is counted here through the ops it calls.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models import get_config as jax_get_config
from repro.quantum import vqc as jvqc
from repro_torch.core import SatQFLConfig
from repro_torch.core.gradients import make_grad_fn
from repro_torch.models import get_config, get_model
from repro_torch.models.registry import ModelApi
from repro_torch.quantum import vqc as tvqc

SMALL = dict(vqc_qubits=4, vqc_layers=2, n_features=4)
CFG_J = jax_get_config("vqc-satqfl").replace(**SMALL)
CFG = get_config("vqc-satqfl").replace(**SMALL)
K, B = 3, 6


def _inputs(seed, lead=(K,)):
    rng = np.random.default_rng(seed)
    nq, L, C = 4, 2, CFG.n_classes
    params = {"theta": rng.uniform(0, np.pi, lead + (L, nq)),
              "phi": rng.uniform(0, np.pi, lead + (L, nq)),
              "w_out": rng.uniform(1, 4, lead + (C,)),
              "b_out": rng.normal(size=lead + (C,))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    batch = {"features": rng.uniform(0, np.pi, lead + (B, 4)).astype(
        np.float32), "labels": rng.integers(0, C, lead + (B,))}
    return params, batch


def _torch(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got: dict, want: dict, atol):
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("chunk", [0, 3])
def test_shift_grad_matches_jax_single_model(chunk):
    params, batch = _inputs(0, lead=())
    want = jvqc.parameter_shift_grad(CFG_J, _jax(params), _jax(batch),
                                     chunk=chunk)
    got = tvqc.parameter_shift_grad(CFG, _torch(params), _torch(batch),
                                    chunk=chunk)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("chunk", [0, 3])
def test_shift_grad_matches_jax_over_clients(chunk):
    """The client axis written out == the JAX rule under the client vmap,
    loss and grads, ≤ 1e-6."""
    params, batch = _inputs(1)
    lj, gj = jax.vmap(lambda p, b: jvqc.parameter_shift_grad(
        CFG_J, p, b, chunk=chunk, with_loss=True))(_jax(params), _jax(batch))
    lt, gt = tvqc.parameter_shift_grad(CFG, _torch(params), _torch(batch),
                                       chunk=chunk, with_loss=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-6)
    _close(gt, gj, 1e-6)


def test_serial_rule_matches_jax_serial_rule():
    params, batch = _inputs(2, lead=())
    want = jvqc.parameter_shift_grad_serial(CFG_J, _jax(params), _jax(batch))
    got = tvqc.parameter_shift_grad_serial(CFG, _torch(params), _torch(batch))
    _close(got, want, 1e-6)


def test_shift_matches_autodiff_over_clients():
    """The stacked rule, the serial rule and the port's autodiff agree per
    client, ≤ 2e-5 (the JAX package's own shift-vs-autodiff contract)."""
    params, batch = _inputs(3)
    tp, tb = _torch(params), _torch(batch)
    shift = tvqc.parameter_shift_grad(CFG, tp, tb)
    serial = tvqc.parameter_shift_grad_serial(CFG, tp, tb)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tvqc.vqc_loss(CFG, leaves, tb).sum().backward()
    for k in leaves:
        np.testing.assert_allclose(shift[k].numpy(), leaves[k].grad.numpy(),
                                   atol=2e-5, err_msg=k)
        np.testing.assert_allclose(serial[k].numpy(), leaves[k].grad.numpy(),
                                   atol=2e-5, err_msg=k)


@pytest.mark.parametrize("chunk,layer_calls", [(0, 1 + 2 + 4),
                                               (3, 1 + 2 + 3 * 4)])
def test_shift_rule_launch_plan(monkeypatch, chunk, layer_calls):
    """Per step: 4·nq·L single-gate ops (one per ± insertion; kernel #3 on
    the card) on (K, B, 2^nq) planes, and 1 + L + L² gate layers (kernel
    #1) — ⌈2·nq / chunk⌉ per suffix layer when chunked — the layers of a
    branch stack with G = K gate sets over 2·nq·B rows (or chunk·B)."""
    gate_shapes, layer_shapes = [], []
    real_gate, real_layer = tvqc.apply_gate, tvqc.apply_gate_layer

    def gate(re, im, g8, q):
        gate_shapes.append((tuple(re.shape), tuple(g8.shape)))
        return real_gate(re, im, g8, q)

    def layer(re, im, g8):
        layer_shapes.append(tuple(re.shape))
        return real_layer(re, im, g8)

    monkeypatch.setattr(tvqc, "apply_gate", gate)
    monkeypatch.setattr(tvqc, "apply_gate_layer", layer)
    params, batch = _inputs(4)
    tvqc.parameter_shift_grad(CFG, _torch(params), _torch(batch), chunk=chunk)
    nq, L = 4, 2
    assert gate_shapes == [((K, B, 16), (K, 8))] * (4 * nq * L)
    assert len(layer_shapes) == layer_calls
    assert layer_shapes[0] == (K * B, 1, 16)                 # encoding
    rows = {shape[1] for shape in layer_shapes[1 + L:]}
    assert rows == ({2 * nq * B} if chunk == 0 else {chunk * B, 2 * B})


def test_grad_fn_runs_the_shift_rule():
    """fl.grad_method='param_shift' selects the model's shift rule with
    the config's chunk and the loss from its base sweep; a model without
    one is refused."""
    params, batch = _inputs(5)
    api = get_model(CFG)
    fl = SatQFLConfig(grad_method="param_shift", shift_chunk=3)
    loss, grads = make_grad_fn(api, CFG, fl)(_torch(params), _torch(batch))
    want_loss, want = tvqc.parameter_shift_grad(
        CFG, _torch(params), _torch(batch), chunk=3, with_loss=True)
    assert torch.equal(loss, want_loss)
    for k in want:
        assert torch.equal(grads[k], want[k])
    np.testing.assert_allclose(loss.numpy(), tvqc.vqc_loss(
        CFG, _torch(params), _torch(batch)).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="shift_grad"):
        make_grad_fn(ModelApi(*api[:5]), CFG, fl)
