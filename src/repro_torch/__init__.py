"""sat-QFL in PyTorch for one NVIDIA H100 — the port of ``repro``.

The layout mirrors ``repro`` file for file, so each module here faces the
JAX module it is held against in the parity tests. The port imports torch
and numpy, never jax and nothing of ``repro``.

Every entry point takes a ``device``: it defaults to ``"cuda"`` and raises
where no GPU is present (see :func:`repro_torch.device.resolve_device`);
pass ``device="cpu"`` to run on the CPU, where each kernel wrapper takes
its plain PyTorch version.

The port covers the trainer's main path: ``SatQFLTrainer`` in modes qfl,
sim, seq and async under ``security`` none, qkd, qkd_fernet or teleport,
with the fault plane and round checkpoints, training the paper's VQC by
autodiff or the parameter-shift rule with its gate layers (resident, or
tiled past 13 qubits) and the shift rule's single gates running as
hand-written CUDA kernels (``repro_torch.kernels.statevec_gate``) and
securing every model exchange with BB84 keys, threefry pads and the
GF(2^31 - 1) MAC, the XOR and MAC fused in a second CUDA kernel
(``repro_torch.kernels.otp_xor``). The same round also runs in-graph over
a stacked satellite axis on the same kernels (``core.dist``, and
``python -m repro_torch.launch.train --fl``). It also serves
``hymba-1.5b``, the hybrid attention ∥ Mamba-2 decoder of the LLM client
zoo (``launch.steps``, ``launch.serve``), its prefill's attention and SSD
scan running as two more CUDA kernels (``kernels.swa_attention``,
``kernels.ssd_scan``). Under a device mesh (``sharding``,
``launch.mesh``) the model steps run on DTensors, the MoE with expert
parallelism; ``launch.dryrun`` traces every (arch × shape) step on a fake
production mesh without allocating a parameter.
"""
