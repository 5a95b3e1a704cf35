"""e2eslam_tpu_torch — the PyTorch + CUDA port of e2eslam_tpu.

Online adaptation of a monocular depth network coupled end to end with
PointFusion SLAM, written in PyTorch for one NVIDIA H100. The subpackages
mirror ``e2eslam_tpu`` by path (``core``, ``models``, ``losses``, ``slam``,
``ops``, ``engine``, ``data``, ``apps``) so each module's counterpart is
found by name. The exact top-1 nearest-neighbour search behind the 3D point
loss runs as hand-written CUDA kernels (``ops/csrc/knn.cu``), built with
``nvcc`` at first use.

Importing this package imports no subpackage, so a CPU-only process can
import any module without touching CUDA.
"""

__version__ = "0.1.0"
