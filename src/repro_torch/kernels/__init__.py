# Hand-written Hopper kernels for the port, each beside its plain PyTorch
# version: `fwht` (Hadamard butterfly) and `wv_step` (fused fine-WV cell
# update).  `build` compiles `csrc/*.cu` into one ctypes-loaded library.
