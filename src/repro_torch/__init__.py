"""sat-QFL in PyTorch for one NVIDIA H100 — the port of ``repro``.

The layout mirrors ``repro`` file for file, so each module here faces the
JAX module it is held against in the parity tests. The port imports torch
and numpy, never jax and nothing of ``repro``.

Every entry point takes a ``device``: it defaults to ``"cuda"`` and raises
where no GPU is present (see :func:`repro_torch.device.resolve_device`);
pass ``device="cpu"`` to run on the CPU, where each kernel wrapper takes
its plain PyTorch version.

This first slice covers the trainer's main path: ``SatQFLTrainer`` in
modes ``qfl`` and ``sim`` under ``security="none"``, training the paper's
VQC with the fused gate layer running as a hand-written CUDA kernel
(``repro_torch.kernels.statevec_gate``).
"""
