"""spark_rapids_tpu_torch: the PyTorch/CUDA port of spark_rapids_tpu.

The JAX package (``spark_rapids_tpu``) is the reference; this package keeps
its module layout and names (``Tpu*`` classes become ``Torch*``) and imports
neither JAX nor anything of the JAX package.

Dtype policy: the reference runs JAX in x64 mode, so LongType is int64 and
DoubleType float64 here too; the Q1 kernel inputs are int32/float32/bool as
in ``kernels.q1.Q1Inputs``. Every tensor is created with an explicit dtype.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
