"""cfdsim_tpu_torch — the PyTorch/CUDA port of ``cfdsim_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``grid``, ``boundary``, ``ops.stencil``, ``solvers.poisson``,
``models.incompressible``, ``cases``, ``runner``, …) and is tested against
it on the same inputs. It imports torch and numpy, never JAX.

Ported so far: the collocated lid-driven cavity's main path — central
convection, explicit diffusion, adaptive dt, the exact DCT pressure
projection — with the fused predictor as a hand-written CUDA kernel for
Hopper (``csrc/predictor.cu``, built by nvcc at first use). Every builder
takes an explicit ``device``; nothing picks one.
"""

__version__ = "0.1.0"
