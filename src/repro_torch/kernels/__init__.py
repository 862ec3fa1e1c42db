"""Hand-written Hopper kernels of the port, one package per TPU kernel.

  statevec_gate — the resident and tiled single-qubit gate layers and
                  the single gate over batched statevectors (the VQC's
                  inner loop and its parameter-shift branches), in CUDA C++
  otp_xor       — the fused OTP-XOR + GF(2^31 - 1) MAC over every edge
                  stream of a secure-exchange stage, in CUDA C++
  swa_attention — sliding-window / causal flash attention of the LLM
                  decoder's prefill, in CUDA C++
  ssd_scan      — the Mamba-2 SSD chunked scan of the same prefill, in
                  CUDA C++

Each package holds ``csrc/`` (the CUDA source), ``build.py`` (its ctypes
binding; ``kernels/build.py`` compiles with nvcc at first use),
``ref.py`` (the plain PyTorch version) and ``ops.py`` (the wrapper: kernel
on CUDA tensors, plain version on CPU tensors, launch count).
"""
