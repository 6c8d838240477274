"""Causal and windowed GQA flash attention (forward): the hand-written
CUDA kernel ``csrc/flash_attention.cu``, its wrapper and its plain PyTorch
version."""
