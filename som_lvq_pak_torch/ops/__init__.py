"""Distance and SOM-step operators: a hand-written CUDA kernel for CUDA
tensors, its plain-PyTorch twin for CPU tensors."""
