"""Hand-written CUDA kernels for the cascade's hot spots, with their plain
PyTorch versions.

cascade_kernel:  B1, the whole-matrix decide; B2, one stage's threshold
                 walk (the chunk decide).
tree_kernel:     B3, oblivious-forest scores.
megakernel:      B4, the fused stage step (score + decide + block prefix).
lattice_kernel:  B5, multilinear lattice scores.
device_executor: the whole stage loop on the device, no host sync.
ops:             public entry points over the kernels.

Sources live in ``repro_torch/csrc/`` and are compiled by ``_build`` at
first use.
"""
