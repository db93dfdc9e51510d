"""PyTorch + CUDA port of the HARP write-and-verify stack.

Mirrors the JAX reference package's layout (`core/`, `readout/`,
`quant/`, `kernels/<name>/{ref,ops}.py`, `obs/`, `models/`, `configs/`)
and imports neither JAX nor the reference.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``; on the
CPU every kernel wrapper runs its plain PyTorch version.
"""
