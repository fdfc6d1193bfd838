"""PyTorch/CUDA port of the QWYC cascade serving path (``repro`` is the JAX
reference).

Module names mirror the JAX package: ``repro_torch.core.qwyc`` is the
counterpart of ``repro.core.qwyc``, and so on.  The kernels that the JAX
package wrote in Pallas for the TPU are hand-written CUDA C++ here
(``csrc/``), built with ``nvcc`` at first use; every kernel wrapper runs
its plain PyTorch version for a CPU tensor and launches the kernel for a
CUDA tensor.
"""
