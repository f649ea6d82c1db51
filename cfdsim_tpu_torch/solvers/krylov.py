"""Matrix-free GMRES and preconditioned CG with the JAX package's
iteration counts (``jax.scipy.sparse.linalg.gmres`` with
``solve_method="incremental"`` and ``jax.scipy.sparse.linalg.cg``, which
the FEM steps call).

Both take an operator ``A`` and a preconditioner ``M`` on a tensor or a
tuple of tensors (the FEM (u, p) pair) and treat the tuple as one vector
throughout: its norms and dot products run over all of its parts. What is
kept of the JAX solvers, because it sets the iteration counts:

- GMRES tolerances: ``atol = max(tol·‖b‖, atol)`` and
  ``ptol = ‖M b‖·min(1, atol/‖b‖)``.
- Left preconditioning: the Arnoldi vector is M(A(v)); the update
  ``x = x0 + V y`` carries no M.
- The outer loop compares the preconditioned residual norm ‖M(b − A x)‖
  with the unpreconditioned ``atol``; the inner loop continues while
  ``k < restart`` and |β_{k+1}| > ``ptol``.
- Orthogonalisation: JAX's iterative classical Gram–Schmidt, whose loop
  as written runs one projection pass (its "twice is enough" repeat
  condition is never met with ``max_iterations=2``); the breakdown guard
  zeroes the new vector when its norm is at most eps·‖M A v‖.
- R starts as ``eye(restart, restart + 1)`` and y solves the full
  ``restart``-sized triangular system, so a restart that stops after m <
  restart steps also adds β_m times the last Arnoldi vector, as JAX's does.
- CG stops when r·r ≤ max(tol²·b·b, atol²) (r·z without M) or at
  ``maxiter``.

The exits depend on the data and a CUDA graph cannot hold them, so each
exit test is read on the host: one read per GMRES setup and restart, one
per Arnoldi step (its Hessenberg column, from which the host applies the
Givens rotations and tests |β_{k+1}| in the system's dtype), one per CG
setup and iteration. The Krylov vectors stay on the device. The solvers
run without autograd: the FEM step's implicit adjoint
(``models/fem.py``) differentiates the solve, not its iterations.
``solve_method="batched"`` (a TPU-only variant without a breakdown guard)
is refused.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch
from scipy.linalg import solve_triangular


def _flattener(b):
    """(pack, unpack) between ``b``'s structure (a tensor or a tuple of
    tensors) and one flat vector."""
    if torch.is_tensor(b):
        shape = b.shape
        return (lambda t: t.reshape(-1)), (lambda v: v.view(shape))
    shapes = [x.shape for x in b]
    sizes = [x.numel() for x in b]

    def pack(tree):
        return torch.cat([x.reshape(-1) for x in tree])

    def unpack(v):
        return tuple(c.view(s) for c, s in zip(torch.split(v, sizes), shapes))

    return pack, unpack


def _norm(v):
    return torch.sqrt(torch.dot(v, v))


def _host(*scalars) -> np.ndarray:
    """One device→host read of 0-dim or 1-D tensors, in their dtype."""
    return torch.cat([s.reshape(-1) for s in scalars]).cpu().numpy()


def _rotate(H, i, cs, sn):
    x1, y1 = H[i], H[i + 1]
    H[i] = cs * x1 - sn * y1
    H[i + 1] = sn * x1 + cs * y1


def _givens(a, b, dt):
    """JAX's ``_givens_rotation`` in the host dtype ``dt``."""
    if b == 0:
        return dt(1), dt(0)
    a_lt_b = abs(a) < abs(b)
    t = -(a / b) if a_lt_b else -(b / a)
    r = dt(1) / np.sqrt(dt(1) + t * t)
    return (r * t, r) if a_lt_b else (r, r * t)


def _operators(A, M, pack, unpack):
    def Af(v):
        return pack(A(unpack(v)))

    def Mf(v):
        return v if M is None else pack(M(unpack(v)))

    return Af, Mf


class _Body:
    """``fn()``, a part of a solver on static buffers: run as it is on the
    CPU or with ``capture=False``; on a CUDA device captured into a CUDA
    graph at its first call (which runs it once,
    ``utils/graphs.py::CapturedProgram``) and replayed after, so its dozens
    of kernels cost the host one launch. The same kernels run in the same
    order either way."""

    def __init__(self, fn, device: torch.device, capture: bool):
        self.fn, self.cuda, self.program = fn, device.type == "cuda" and capture, None

    def __call__(self):
        if not self.cuda:
            self.fn()
        elif self.program is None:
            from cfdsim_tpu_torch.utils.graphs import CapturedProgram

            self.program = CapturedProgram(self.fn)
        else:
            self.program.replay()


class Workspace:
    """The static buffers and iteration bodies of one solver call site. Pass
    the same ``Workspace`` to every solve at a site (a step's momentum GMRES,
    its pressure CG) and on a CUDA device the bodies are captured in the
    first solve and replayed in every later one; without one, each solve
    captures its own. The operator and preconditioner must then be the same
    callables at every solve and read only memory that outlives the solves
    (the step's own buffers); a solve with another operator, preconditioner,
    size, restart or dtype raises."""

    def __init__(self):
        self.key = None

    def bind(self, key) -> bool:
        """True at the first solve (the caller builds the buffers), False at
        a later one with the same key; another key raises."""
        if self.key is None:
            self.key = key
            return True
        if key != self.key:
            raise ValueError("a Krylov workspace is bound to one operator, preconditioner, "
                             "size and restart")
        return False


def _dtype_of(t: torch.Tensor):
    return np.dtype(str(t.dtype).removeprefix("torch.")).type


@torch.no_grad()
def gmres(A, b, x0=None, *, tol=1e-5, atol=0.0, restart=20, maxiter=None, M=None,
          solve_method="incremental", counts=None, capture=True, workspace=None):
    """Solve A x = b by restarted, left-preconditioned GMRES; returns x in
    ``b``'s structure. ``counts`` (a ``collections.Counter``) gains the
    matvecs, preconditioner applications, Arnoldi steps, restarts and host
    reads of the solve. ``A`` and ``M`` must read nothing on the host: on a
    CUDA device the setup, an Arnoldi step and a restart's end are each
    captured (once per ``workspace``, see :class:`Workspace`) and replayed;
    ``capture=False`` runs them eagerly (the implicit adjoint's transposed
    solve, whose operator is an autograd pull-back)."""
    if solve_method != "incremental":
        raise ValueError(
            f"solve_method {solve_method!r}: only 'incremental' is ported ('batched' "
            "has no float32 breakdown guard and is a TPU-only option)")
    counts = Counter() if counts is None else counts
    pack, unpack = _flattener(b)
    bf = pack(b)
    n = bf.numel()
    restart = min(restart, n)
    maxiter = 10 * n if maxiter is None else maxiter
    dt = _dtype_of(bf)
    eps = np.finfo(dt).eps
    w = Workspace() if workspace is None else workspace
    if w.bind(("gmres", A, M, n, restart, bf.dtype, bf.device, capture)):
        _gmres_buffers(w, A, M, pack, unpack, bf, restart, eps, capture)
    w.b.copy_(bf)
    if x0 is None:
        w.x.zero_()
    else:
        w.x.copy_(pack(x0))
    pc = int(M is not None)

    w.start()
    b_norm, mb_norm, r_norm_h = _host(w.norms)
    counts.update(matvecs=1, precond=2 * pc, host_reads=1)
    atol = np.maximum(dt(tol) * b_norm, dt(atol))
    with np.errstate(divide="ignore", invalid="ignore"):
        ptol = mb_norm * np.minimum(dt(1), atol / b_norm)
    r_norm_h = r_norm_h if r_norm_h > eps else dt(0)

    restarts = 0
    while restarts < maxiter and r_norm_h > atol:
        # one restart: the Arnoldi process with incremental Givens QR on the
        # host, then x + V y and the new preconditioned residual
        R = np.eye(restart, restart + 1, dtype=dt)
        givens = np.zeros((restart, 2), dtype=dt)
        beta = np.zeros(restart + 1, dtype=dt)
        beta[0] = r_norm_h
        k, err = 0, r_norm_h
        while k < restart and err > ptol:
            w.arnoldi()
            h = _host(w.column)
            row = np.zeros(restart + 1, dtype=dt)
            row[: k + 1] = h[: k + 1]
            row[k + 1] = h[-1]
            for i in range(k):
                _rotate(row, i, *givens[i])
            givens[k] = _givens(row[k], row[k + 1], dt)
            _rotate(row, k, *givens[k])
            R[k] = row
            _rotate(beta, k, *givens[k])
            err = abs(beta[k + 1])
            k += 1
        counts.update(matvecs=k + 1, precond=(k + 1) * pc, arnoldi=k, restarts=1,
                      host_reads=k + 1)
        y = np.zeros(restart + 1, dtype=dt)
        # y is beta itself past the k steps taken (R's identity rows)
        y[:restart] = solve_triangular(R[:, :-1].T, beta[:-1], lower=False, check_finite=False)
        w.y.copy_(torch.from_numpy(y))
        w.finish()
        (r_norm_h,) = _host(w.norms[2:])
        r_norm_h = r_norm_h if r_norm_h > eps else dt(0)
        restarts += 1
    return unpack(w.x.clone())


def _gmres_buffers(w, A, M, pack, unpack, like, restart, eps, capture):
    """A GMRES workspace's buffers and bodies. The Krylov basis is one
    vector a row; rows past the current step are zero, so the projections
    run over all of them (as JAX's do) and every step has the same shapes."""
    Af, Mf = _operators(A, M, pack, unpack)
    n = like.numel()
    w.b, w.x = torch.zeros_like(like), torch.zeros_like(like)
    V = w.V = like.new_zeros((restart + 1, n))
    k_dev = torch.zeros(1, dtype=torch.int64, device=like.device)
    w.column = like.new_zeros(restart + 2)  # an Arnoldi step's h, then ‖w‖
    w.y = like.new_zeros(restart + 1)  # a restart's coefficients, zero-padded
    w.norms = like.new_zeros(3)  # ‖b‖, ‖M b‖, ‖M(b − A x)‖

    def set_residual():
        """V[0] = r/‖r‖ (0 at or below eps) for r = M(b − A x); ‖r‖."""
        r = Mf(w.b - Af(w.x))
        rn = _norm(r)
        V.zero_()
        V[0].copy_(torch.where(rn > eps, r / rn, 0.0))
        w.norms[2:].copy_(rn.reshape(1))
        k_dev.zero_()

    def start():
        set_residual()
        w.norms[0] = _norm(w.b)
        w.norms[1] = _norm(Mf(w.b))

    def arnoldi():
        v = Mf(Af(V.index_select(0, k_dev)[0]))
        n0 = _norm(v)
        n0 = torch.where(n0 > eps, n0, 0.0)
        h = V @ v  # classical Gram–Schmidt, one pass
        v = v - h @ V
        n1 = _norm(v)
        use = n1 > eps * n0  # the breakdown guard
        V.index_copy_(0, k_dev + 1, torch.where(use, v / n1, 0.0)[None])
        w.column[:-1].copy_(h)
        w.column[-1:].copy_(torch.where(use, n1, 0.0).reshape(1))
        k_dev.add_(1)

    def finish():
        w.x.add_(w.y @ V)
        set_residual()

    w.start, w.arnoldi, w.finish = (_Body(f, like.device, capture)
                                    for f in (start, arnoldi, finish))


@torch.no_grad()
def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None, counts=None,
       workspace=None):
    """Solve A x = b (A symmetric positive definite) by preconditioned
    conjugate gradients; returns x in ``b``'s structure. ``counts`` gains
    the matvecs, preconditioner applications, iterations and host reads.
    On a CUDA device the setup and an iteration are captured (once per
    ``workspace``, see :class:`Workspace`) and replayed."""
    counts = Counter() if counts is None else counts
    pack, unpack = _flattener(b)
    bf = pack(b)
    dt = _dtype_of(bf)
    maxiter = 10 * bf.numel() if maxiter is None else maxiter
    w = Workspace() if workspace is None else workspace
    if w.bind(("cg", A, M, bf.numel(), bf.dtype, bf.device)):
        _cg_buffers(w, A, M, pack, unpack, bf)
    w.b.copy_(bf)
    if x0 is None:
        w.x.zero_()
    else:
        w.x.copy_(pack(x0))
    pc = int(M is not None)

    w.start()
    bs, rs = _host(w.sums)
    counts.update(matvecs=1, precond=pc, host_reads=1)
    atol2 = np.maximum(dt(tol) * dt(tol) * bs, dt(atol) * dt(atol))
    k = 0
    while rs > atol2 and k < maxiter:
        w.iteration()
        k += 1
        (rs,) = _host(w.sums[1:])
    counts.update(matvecs=k, precond=k * pc, cg_iterations=k, host_reads=k)
    return unpack(w.x.clone())


def _cg_buffers(w, A, M, pack, unpack, like):
    """A CG workspace's buffers and bodies."""
    Af, Mf = _operators(A, M, pack, unpack)
    w.b, w.x, r, p = (torch.zeros_like(like) for _ in range(4))
    gamma = like.new_zeros(())
    w.sums = like.new_zeros(2)  # b·b, then the exit test's r·r (r·z without M)

    def start():
        r.copy_(w.b - Af(w.x))
        p.copy_(Mf(r))
        gamma.copy_(torch.dot(r, p))
        w.sums[0] = torch.dot(w.b, w.b)
        w.sums[1] = torch.dot(r, r) if M is not None else gamma

    def iteration():
        Ap = Af(p)
        alpha = gamma / torch.dot(p, Ap)
        w.x.add_(alpha * p)
        r.sub_(alpha * Ap)
        z = Mf(r)
        gamma_new = torch.dot(r, z)
        p.mul_(gamma_new / gamma).add_(z)  # p = z + β p
        gamma.copy_(gamma_new)
        w.sums[1] = torch.dot(r, r) if M is not None else gamma_new

    w.start, w.iteration = (_Body(f, like.device, True) for f in (start, iteration))
