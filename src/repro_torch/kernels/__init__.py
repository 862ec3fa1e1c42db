"""Hand-written Hopper kernels of the port, one package per TPU kernel.

  statevec_gate — the fused single-qubit gate layer over batched
                  statevectors (the VQC's inner loop), in CUDA C++

Each package holds ``csrc/`` (the CUDA source), ``build.py`` (nvcc build
and ctypes binding, at first use), ``ref.py`` (the plain PyTorch version)
and ``ops.py`` (the wrapper: kernel on CUDA tensors, plain version on CPU
tensors, autograd, launch count).
"""
