# Hand-written Hopper kernels for the port, each beside its plain PyTorch
# version: `fwht` (Hadamard butterfly), `wv_step` (fused fine-WV cell
# update) and `acim_vmm` (bit-sliced analog VMM with its ADC epilogue).
# `build` compiles `csrc/*.cu` into one ctypes-loaded library.
