"""Kernel wrappers with their plain PyTorch versions, and the CUDA builder.

Each wrapper runs its plain version on CPU tensors and launches its
hand-written CUDA kernel (csrc/) on CUDA tensors, counting launches in a
plain integer attribute (`<wrapper>.launches`).
"""
