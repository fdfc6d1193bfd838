"""Hand-written CUDA kernels for the cascade's hot spots, with their plain
PyTorch versions.

cascade_kernel:  B1, the whole-matrix decide; B2, one stage's threshold
                 walk (the chunk decide), and its step form with the batch
                 stage's compaction; B6, the walk with a threshold row
                 per lane (the lane decide of streaming admission); B8, the
                 group decide of a ranking cascade.
tree_kernel:     B3, oblivious-forest scores.
megakernel:      B4, the fused stage step (score + decide + block prefix);
                 B7, the same for lanes at different stages (streaming).
lattice_kernel:  B5, multilinear lattice scores.
device_executor: the whole stage loop on the device, no host sync, the
                 streaming admission loop and the grouped (ranking) loop.
ops:             public entry points over the kernels.

Sources live in ``repro_torch/csrc/`` and are compiled by ``_build`` at
first use.
"""
