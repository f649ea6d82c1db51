"""cfdsim_tpu_torch — the PyTorch/CUDA port of ``cfdsim_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``grid``, ``boundary``, ``ops.stencil``, ``solvers.poisson``,
``models.incompressible``, ``cases``, ``runner``, …) and is tested against
it on the same inputs. It imports torch and numpy, never JAX.

Ported so far: the collocated tier's cavity, channel and immersed
cylinder — central, upwind and SUPG convection, explicit diffusion,
adaptive or fixed dt with warm-up, IBM penalization, the DCT and iterative
pressure solves (Jacobi, red-black SOR, multigrid, hybrid, periodic FFT) —
with every Pallas kernel of the JAX package as a hand-written CUDA kernel
for Hopper (``csrc/predictor.cu``, ``csrc/rbsor.cu``, built by nvcc at
first use). Every builder takes an explicit ``device``; nothing picks one.
"""

__version__ = "0.1.0"
