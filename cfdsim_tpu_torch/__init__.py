"""cfdsim_tpu_torch — the PyTorch/CUDA port of ``cfdsim_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``grid``, ``boundary``, ``ops.stencil``, ``solvers.poisson``,
``models.incompressible``, ``cases``, ``runner``, …) and is tested against
it on the same inputs. It imports torch and numpy, never JAX.

Ported so far: the collocated 2D incompressible tier and its run
pipeline, and the staggered (MAC) tiers, uniform and stretched. The cases
cavity, channel, immersed cylinder and scalar transport; cavity_mac,
cylinder_mac, cylinder_oscillating, cavity_stretched and
cylinder_stretched; central, upwind, TVD and SUPG convection; explicit or implicit
(DST Helmholtz or damped Jacobi) diffusion; Smagorinsky LES; body forcing;
adaptive or fixed dt with warm-up; IBM penalization; the DCT and iterative
pressure solves (Jacobi, red-black SOR, multigrid, hybrid, periodic FFT;
every DCT variant, autotuned per device and shape; fast diagonalization);
roofline counts;
the chunked runner with snapshots (HDF5 and the native writer), resume,
render, video and thin. Every Pallas kernel of the JAX package is a
hand-written CUDA kernel for Hopper (``csrc/predictor.cu``,
``csrc/rbsor.cu``, built by nvcc at first use). Every case function takes an
explicit ``device``; nothing picks one.
"""

__version__ = "0.1.0"
