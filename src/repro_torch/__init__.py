"""PyTorch/CUDA port of the MUXQ serving system (``src/repro`` is the JAX
reference).  Plain tensor code is PyTorch; the hot kernels are
hand-written CUDA for Hopper under ``csrc/``, each with a plain PyTorch
version that CPU tensors take."""
