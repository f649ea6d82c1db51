"""Plain PyTorch reference of the collocated 2D projection step.

One step of the incompressible Navier–Stokes solver that the benchmark's
configurations state (``configs/*.json``, key ``problem``): adaptive dt from
the CFL and viscous bounds, convection (central, first-order upwind, or the
SUPG form with the upstream reference's halved scaling), the explicit
viscous predictor, the boundary conditions (lid-driven cavity, or the
cylinder's perturbed inflow, outflow and walls), the penalization of the
immersed body, the pressure solve (the clamped-edge Neumann problem: exact
by its eigenbasis, masked red-black SOR with its early exit, or multigrid
V-cycles), the corrector, the divergence clean-up sweeps, and the per-step
diagnostics.

It is written from the equations, in plain torch operations, and imports
nothing of the program under test: the grid, the masks, the initial
potential flow, the eigenvalues, the colours and the multigrid levels are
all worked out here again. ``dtype`` sets the precision of every field and
operation: float32 is the reference; a lower one (bfloat16) is the control
that the comparison must refuse. The eigenbasis solve of the float32
reference multiplies its matrices in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

METRICS = ("dt", "div_pre", "div_post", "max_vel", "energy", "vort_max", "poisson_res",
           "fx", "fy", "fz")


# ---------------------------------------------------------------------------
# geometry and inputs
# ---------------------------------------------------------------------------

def spacing(problem: dict) -> tuple[float, float]:
    """Node-centred spacing: the domain's length over n − 1 intervals."""
    return problem["lx"] / (problem["nx"] - 1), problem["ly"] / (problem["ny"] - 1)


def node_coords(problem: dict) -> tuple[np.ndarray, np.ndarray]:
    """(X, Y), float64, shape (ny, nx): node coordinates, row = y."""
    x = np.linspace(0.0, problem["lx"], problem["nx"])
    y = np.linspace(0.0, problem["ly"], problem["ny"])
    return np.meshgrid(x, y, indexing="xy")


def cylinder_geometry(problem: dict):
    """(solid bool, penalization weight float32, distance float64): the
    body is the disc of ``radius`` about ``center``; the weight is 1 inside
    and a Gaussian shell exp(−((r − R)/2dx)²) out to R + 5dx."""
    X, Y = node_coords(problem)
    cx, cy = problem["center"]
    radius = problem["radius"]
    dx, _ = spacing(problem)
    dist = np.sqrt((X - cx) ** 2 + (Y - cy) ** 2)
    shell = np.exp(-(((dist - radius) / (2.0 * dx)) ** 2))
    weight = np.where(dist < radius, 1.0, np.where(dist < radius + 5.0 * dx, shell, 0.0))
    return dist <= radius, weight.astype(np.float32), dist


def fluid_cells(problem: dict) -> int:
    """Cells that the pressure solve updates (the masked solve skips the body)."""
    n = problem["nx"] * problem["ny"]
    if problem["kind"] == "cylinder" and problem["poisson"].get("masked", False):
        n -= int(cylinder_geometry(problem)[0].sum())
    return n


def base_fields(problem: dict) -> tuple[np.ndarray, np.ndarray]:
    """The case's own start, float32: the cavity at rest; around the
    cylinder the ideal potential flow, blended to rest across four cells
    off the body and damped by the penalization weight."""
    shape = (problem["ny"], problem["nx"])
    if problem["kind"] == "cavity":
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    X, Y = node_coords(problem)
    cx, cy = problem["center"]
    radius, v_inf = problem["radius"], problem["v_inf"]
    dx, _ = spacing(problem)
    _, weight, r = cylinder_geometry(problem)
    theta = np.arctan2(Y - cy, X - cx)
    factor = (radius / np.maximum(r, 1e-10)) ** 2
    u_far = v_inf * (1.0 - factor * np.cos(2.0 * theta)) * (1.0 - weight)
    v_far = -v_inf * factor * np.sin(2.0 * theta) * (1.0 - weight)
    u_near = v_inf * np.minimum(1.0, ((r - radius) / (4.0 * dx)) ** 2) * (1.0 - weight)
    far = r > radius + 4.0 * dx
    return (np.where(far, u_far, u_near).astype(np.float32),
            np.where(far, v_far, 0.0).astype(np.float32))


# ---------------------------------------------------------------------------
# stencils: zero on the one-node frame
# ---------------------------------------------------------------------------

def _frame(interior):
    return F.pad(interior, (1, 1, 1, 1))


def _ddx(f, dx):
    return (f[1:-1, 2:] - f[1:-1, :-2]) * (0.5 / dx)


def _ddy(f, dy):
    return (f[2:, 1:-1] - f[:-2, 1:-1]) * (0.5 / dy)


def divergence(u, v, dx, dy):
    return _frame(_ddx(u, dx) + _ddy(v, dy))


def curl(u, v, dx, dy):
    return _frame(_ddx(v, dx) - _ddy(u, dy))


def gradient(f, dx, dy):
    return _frame(_ddx(f, dx)), _frame(_ddy(f, dy))


def laplacian(f, dx, dy):
    c = f[1:-1, 1:-1]
    return _frame((f[1:-1, 2:] - 2.0 * c + f[1:-1, :-2]) * (1.0 / (dx * dx))
                  + (f[2:, 1:-1] - 2.0 * c + f[:-2, 1:-1]) * (1.0 / (dy * dy)))


def convection(u, v, f, dx, dy, scheme: str, tau=None):
    """u·∇f on the interior: ``central``; ``upwind`` (one-sided difference
    from the side the velocity comes from); ``supg`` and ``supg_refparity``
    (central minus τ(u ∂²f/∂x² + v ∂²f/∂y²) where τ > 0; the upstream
    reference halves both derivative scalings)."""
    uc, vc, fc = u[1:-1, 1:-1], v[1:-1, 1:-1], f[1:-1, 1:-1]
    if scheme == "upwind":
        fx = torch.where(uc > 0, (fc - f[1:-1, :-2]) * (1.0 / dx), (f[1:-1, 2:] - fc) * (1.0 / dx))
        fy = torch.where(vc > 0, (fc - f[:-2, 1:-1]) * (1.0 / dy), (f[2:, 1:-1] - fc) * (1.0 / dy))
        return _frame(uc * fx + vc * fy)
    half = scheme == "supg_refparity"
    d1x, d1y = (0.25 / dx, 0.25 / dy) if half else (0.5 / dx, 0.5 / dy)
    std = uc * ((f[1:-1, 2:] - f[1:-1, :-2]) * d1x) + vc * ((f[2:, 1:-1] - f[:-2, 1:-1]) * d1y)
    if scheme == "central":
        return _frame(std)
    d2x, d2y = ((0.5 / dx) ** 2, (0.5 / dy) ** 2) if half else (1.0 / dx ** 2, 1.0 / dy ** 2)
    lx = (f[1:-1, 2:] - 2.0 * fc + f[1:-1, :-2]) * d2x
    ly = (f[2:, 1:-1] - 2.0 * fc + f[:-2, 1:-1]) * d2y
    tc = tau[1:-1, 1:-1]
    return _frame(torch.where(tc > 0, std - tc * (uc * lx + vc * ly), std))


def supg_tau(u, v, h: float, dt, nu: float):
    """τ = h/(2|u|)·min(1, Pe/2), Pe = |u|h/ν; dt/2 where the flow stands."""
    speed = torch.sqrt(u * u + v * v)
    pe = speed * h / (nu + 1e-10)
    tau = h / (2.0 * speed.clamp(min=1e-10)) * (pe / 2.0).clamp(max=1.0)
    return _frame(torch.where(speed > 1e-10, tau, dt / 2.0)[1:-1, 1:-1])


# ---------------------------------------------------------------------------
# the clamped-edge Neumann Poisson problem: ∇²φ = rhs, ghost = edge value
# ---------------------------------------------------------------------------

def _clamped(f):
    """(east, west, north, south) neighbours with the edge value as ghost."""
    e = torch.cat([f[:, 1:], f[:, -1:]], 1)
    w = torch.cat([f[:, :1], f[:, :-1]], 1)
    n = torch.cat([f[1:], f[-1:]], 0)
    s = torch.cat([f[:1], f[:-1]], 0)
    return e, w, n, s


def neumann_laplacian(f, dx, dy):
    ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
    e, w, n, s = _clamped(f)
    return ax * (e + w) + ay * (n + s) - 2.0 * (ax + ay) * f


def residual(phi, rhs, dx, dy, solid=None):
    r = (neumann_laplacian(phi, dx, dy) - rhs).abs()
    if solid is not None:
        r = torch.where(solid, torch.zeros_like(r), r)
    return r.amax()


def _dct_basis(n: int, device) -> torch.Tensor:
    """Orthonormal DCT-II matrix (float64): the eigenvectors of the 1D
    clamped-edge second difference."""
    k = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    c = np.cos(np.pi * k * (2 * j + 1) / (2 * n)) * np.sqrt(2.0 / n)
    c[0] /= np.sqrt(2.0)
    return torch.from_numpy(c).to(device)


class EigenSolve:
    """Exact solve in the eigenbasis: φ = Cᵧᵀ((Cᵧ rhs Cₓᵀ)/λ)Cₓ, with the
    constant mode (λ = 0) projected out. The float32 reference multiplies
    in float64 (so no TF32 setting can lower it) and rounds φ once; a
    lower ``dtype`` multiplies in that type."""

    def __init__(self, shape, dx, dy, dtype, device):
        ny, nx = shape
        self.dtype = dtype
        self.work = torch.float64 if dtype == torch.float32 else dtype
        self.cy = _dct_basis(ny, device).to(self.work)
        self.cx = _dct_basis(nx, device).to(self.work)
        sy = np.sin(np.pi * np.arange(ny) / (2 * ny)) ** 2
        sx = np.sin(np.pi * np.arange(nx) / (2 * nx)) ** 2
        lam = (-4.0 / (dy * dy)) * sy[:, None] + (-4.0 / (dx * dx)) * sx[None, :]
        lam[0, 0] = 1.0
        inv = 1.0 / lam
        inv[0, 0] = 0.0
        self.inv = torch.from_numpy(inv).to(device=device, dtype=self.work)

    def __call__(self, phi0, rhs):
        spec = self.cy @ rhs.to(self.work) @ self.cx.T
        return (self.cy.T @ (spec * self.inv) @ self.cx).to(self.dtype)


def _colours(shape, solid, device):
    i = torch.arange(shape[0], device=device)[:, None]
    j = torch.arange(shape[1], device=device)[None, :]
    red = (i + j) % 2 == 0
    if solid is None:
        return red, ~red
    return red & ~solid, ~red & ~solid


def _sor_sweeps(phi, rhs, dx, dy, sweeps, omega, colours):
    """Red-black SOR: each colour relaxes towards its neighbours' value,
    the black half reading the red half's new values."""
    ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
    inv = 1.0 / (2.0 * (ax + ay))
    for _ in range(sweeps):
        for colour in colours:
            e, w, n, s = _clamped(phi)
            star = (((e + w) * ax + ay * n) + ay * s - rhs) * inv
            phi = torch.where(colour, (1.0 - omega) * phi + omega * star, phi)
    return phi


class SorSolve:
    """Masked red-black SOR with the early exit: chunks of ``check_every``
    sweeps, at most ``iters // check_every`` of them, each run only while
    the residual after the last one is above ``tol``. On a card a chunk is
    replayed from one CUDA graph (the same operations, launched at once)."""

    def __init__(self, shape, dx, dy, cfg: dict, solid, device):
        self.dx, self.dy, self.cfg = dx, dy, cfg
        self.solid = solid
        self.colours = _colours(shape, solid, device)
        self.graph = None
        self.device = torch.device(device)

    def _chunk(self, phi, rhs):
        c = self.cfg
        return _sor_sweeps(phi, rhs, self.dx, self.dy, c["check_every"], c["omega"],
                           self.colours)

    def _run_chunk(self, phi, rhs):
        if self.device.type != "cuda":
            return self._chunk(phi, rhs)
        if self.graph is None:
            self.phi_in = phi.clone()
            self.rhs_in = rhs.clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._chunk(self.phi_in, self.rhs_in)
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.phi_out = self._chunk(self.phi_in, self.rhs_in)
        self.phi_in.copy_(phi)
        self.rhs_in.copy_(rhs)
        self.graph.replay()
        return self.phi_out.clone()

    def __call__(self, phi, rhs):
        c = self.cfg
        for _ in range(max(1, c["iters"] // c["check_every"])):
            phi = self._run_chunk(phi, rhs)
            if not float(residual(phi, rhs, self.dx, self.dy, self.solid)) > c["tol"]:
                break
        return phi


def _restrict(r):
    ny, nx = r.shape
    return r.reshape(ny // 2, 2, nx // 2, 2).mean(dim=(1, 3))


def _prolong_axis(e, axis):
    """Bilinear cell-centred prolongation along ``axis``, clamped ends:
    fine 2i ← (3/4, 1/4) of coarse (i, i − 1), fine 2i + 1 ← (i, i + 1)."""
    n = e.shape[axis]
    lo = torch.cat([e.narrow(axis, 0, 1), e.narrow(axis, 0, n - 1)], axis)
    hi = torch.cat([e.narrow(axis, 1, n - 1), e.narrow(axis, n - 1, 1)], axis)
    shape = list(e.shape)
    shape[axis] *= 2
    return torch.stack([0.75 * e + 0.25 * lo, 0.75 * e + 0.25 * hi], axis + 1).reshape(shape)


class MultigridSolve:
    """``cycles`` V-cycles warm-started from the last φ: red-black
    Gauss–Seidel smoothing (``pre`` and ``post`` sweeps, ``coarse`` on the
    coarsest level), full-weighting restriction of the residual, bilinear
    prolongation of the correction; levels halve while both sides are even
    and the halved side stays ≥ ``min_size``."""

    def __init__(self, shape, dx, dy, cfg: dict, device):
        self.cfg, self.dx, self.dy = cfg, dx, dy
        shapes = [tuple(shape)]
        ny, nx = shape
        while ny % 2 == 0 and nx % 2 == 0 and min(ny, nx) // 2 >= cfg["min_size"]:
            ny, nx = ny // 2, nx // 2
            shapes.append((ny, nx))
        self.colours = [_colours(s, None, device) for s in shapes]

    def _vcycle(self, phi, rhs, dx, dy, level):
        c = self.cfg
        colours = self.colours[level]
        phi = _sor_sweeps(phi, rhs, dx, dy, c["pre"], 1.0, colours)
        if level == len(self.colours) - 1:
            return _sor_sweeps(phi, rhs, dx, dy, c["coarse"], 1.0, colours)
        r = rhs - neumann_laplacian(phi, dx, dy)
        e = self._vcycle(torch.zeros_like(r[::2, ::2]), _restrict(r), 2 * dx, 2 * dy, level + 1)
        phi = phi + _prolong_axis(_prolong_axis(e, 0), 1)
        return _sor_sweeps(phi, rhs, dx, dy, c["post"], 1.0, colours)

    def __call__(self, phi, rhs):
        for _ in range(self.cfg["cycles"]):
            phi = self._vcycle(phi, rhs, self.dx, self.dy, 0)
        return phi


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

class ReferenceFlow:
    """``step(state, cfl_scale) -> (state, metrics)`` for one stated problem,
    every field and operation in ``dtype``. A state is a dict of ``u``,
    ``v``, ``p`` (fields), ``t`` (0-dim) and ``step`` (an int)."""

    def __init__(self, problem: dict, device, dtype=torch.float32):
        self.pb = problem
        self.device = torch.device(device)
        self.dtype = dtype
        self.dx, self.dy = spacing(problem)
        self.h = min(self.dx, self.dy)
        self.shape = (problem["ny"], problem["nx"])
        self.nu = problem["nu"] + problem.get("artificial_viscosity", 0.0)
        pois = problem["poisson"]
        self.solid = self.weight = None
        if problem["kind"] == "cylinder":
            solid, weight, _ = cylinder_geometry(problem)
            self.weight = torch.from_numpy(weight).to(device=device, dtype=dtype)
            if pois.get("masked", False):
                self.solid = torch.from_numpy(solid).to(device)
            y = np.linspace(0.0, problem["ly"], problem["ny"])
            self.inflow_phase = torch.from_numpy(2.0 * np.pi * y / problem["ly"]).to(
                device=device, dtype=dtype)
        imask = torch.zeros(self.shape, dtype=torch.bool, device=device)
        imask[2:-2, 2:-2] = True
        self.imask = imask
        method = pois["method"]
        if method == "eigen":
            self.solve = EigenSolve(self.shape, self.dx, self.dy, dtype, device)
        elif method == "sor":
            self.solve = SorSolve(self.shape, self.dx, self.dy, pois, self.solid, device)
        elif method == "multigrid":
            self.solve = MultigridSolve(self.shape, self.dx, self.dy, pois, device)
        else:
            raise ValueError(f"unknown pressure solve {method!r}")
        # the exact solve drops the constant mode itself; the iterative ones
        # take a mean-free right-hand side
        self.mean_free_rhs = method != "eigen"

    # -- the start ----------------------------------------------------------
    def initial_state(self, perturbation: tuple) -> dict:
        """The stated start plus the benchmark's perturbation (du, dv)."""
        u0, v0 = base_fields(self.pb)
        du, dv = perturbation
        cast = dict(device=self.device, dtype=self.dtype)
        u = torch.from_numpy(u0).to(**cast) + du.to(**cast)
        v = torch.from_numpy(v0).to(**cast) + dv.to(**cast)
        return {"u": u, "v": v, "p": torch.zeros(self.shape, **cast),
                "t": torch.zeros((), **cast), "step": 0}

    # -- boundary conditions --------------------------------------------------
    def _bcs(self, u, v, step: int):
        u, v = u.clone(), v.clone()
        pb = self.pb
        if pb["kind"] == "cavity":
            for f in (u, v):
                f[:, 0] = 0.0
                f[:, -1] = 0.0
                f[0, :] = 0.0
            u[-1, :] = pb["lid_velocity"]
            v[-1, :] = 0.0
            return u, v
        amp = min(step / pb["inflow_ramp_steps"], 1.0) * pb["inflow_perturbation"]
        u[:, 0] = pb["v_inf"] * (1.0 + amp * torch.sin(self.inflow_phase + 0.02 * step))
        v[:, 0] = 0.0
        u[:, -1] = u[:, -2]
        v[:, -1] = v[:, -2]
        for f in (u, v):
            f[0, :] = 0.0
            f[-1, :] = 0.0
        return u, v

    def _dt(self, u, v, step: int, cfl_scale: float):
        pb = self.pb
        if step < pb.get("warmup_steps", 0):
            return torch.tensor(pb["warmup_dt"], dtype=self.dtype, device=self.device)
        speed = torch.maximum(u.abs().amax(), v.abs().amax()).clamp(min=1e-10)
        dt = cfl_scale * pb["cfl"] * self.h / speed
        dt = dt.clamp(max=0.2 * self.h * self.h / self.nu)
        return dt.clamp(pb["dt_min"], pb["dt_max"])

    def _cleanup(self, u, v):
        """Projection sweeps after the corrector: φ (zero on the frame) takes
        one Jacobi update of ∇²φ = ∇·u per sweep, then u −= ∇φ."""
        dx, dy = self.dx, self.dy
        ax, ay = 1.0 / (dx * dx), 1.0 / (dy * dy)
        phi = torch.zeros_like(u)
        for _ in range(self.pb.get("cleanup_iters", 0)):
            nb = _frame(ax * (phi[1:-1, 2:] + phi[1:-1, :-2]) + ay * (phi[2:, 1:-1] + phi[:-2, 1:-1]))
            phi = (nb - divergence(u, v, dx, dy)) * (1.0 / (2.0 * (ax + ay)))
            gx, gy = gradient(phi, dx, dy)
            u, v = u - gx, v - gy
        return u, v

    def step(self, state: dict, cfl_scale: float = 1.0):
        pb, dx, dy = self.pb, self.dx, self.dy
        u, v, p, n = state["u"], state["v"], state["p"], state["step"]
        dt = self._dt(u, v, n, cfl_scale)
        scheme = pb["scheme"]
        tau = supg_tau(u, v, self.h, dt, self.nu) if scheme.startswith("supg") else None
        us = u + dt * (self.nu * laplacian(u, dx, dy) - convection(u, v, u, dx, dy, scheme, tau))
        vs = v + dt * (self.nu * laplacian(v, dx, dy) - convection(u, v, v, dx, dy, scheme, tau))
        us, vs = self._bcs(us, vs, n)
        removed = []
        if self.weight is not None:
            ramp = pb.get("ibm_ramp_steps", 0)
            damp = 1.0 - self.weight * (min(n / ramp, 1.0) if ramp > 0 else 1.0)
            removed.append((us * (1.0 - damp), vs * (1.0 - damp)))
            us, vs = us * damp, vs * damp
        div_star = divergence(us, vs, dx, dy)
        rhs = div_star / dt
        if self.mean_free_rhs:
            rhs = rhs - rhs.mean()
        phi = self.solve(p, rhs)
        gx, gy = gradient(phi, dx, dy)
        un, vn = self._cleanup(us - dt * gx, vs - dt * gy)
        un, vn = self._bcs(un, vn, n)
        if self.weight is not None:
            removed.append((un * (1.0 - damp), vn * (1.0 - damp)))
            un, vn = un * damp, vn * damp
        lim = pb["max_velocity"]
        un, vn = un.clamp(-lim, lim), vn.clamp(-lim, lim)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        fx = fy = zero
        if removed:
            fx = sum(a.sum() for a, _ in removed) * (dx * dy) / dt
            fy = sum(b.sum() for _, b in removed) * (dx * dy) / dt
        metrics = {
            "dt": dt,
            "div_pre": div_star.abs().amax(),
            "div_post": (divergence(un, vn, dx, dy).abs() * self.imask).amax(),
            "max_vel": torch.maximum(un.abs().amax(), vn.abs().amax()),
            "energy": (0.5 * (un * un + vn * vn)).mean(),
            "vort_max": curl(un, vn, dx, dy).abs().amax(),
            "poisson_res": residual(phi, rhs, dx, dy, self.solid),
            "fx": fx, "fy": fy, "fz": zero,
        }
        return {"u": un, "v": vn, "p": phi, "t": state["t"] + dt, "step": n + 1}, metrics

    def run(self, state: dict, steps: int, cfl_scale: float = 1.0):
        """``steps`` steps; returns (state, metrics as a float64 numpy array
        of shape (steps, len(METRICS)))."""
        rows = []
        for _ in range(steps):
            state, m = self.step(state, cfl_scale)
            rows.append(torch.stack([m[k].to(torch.float32) for k in METRICS]))
        return state, torch.stack(rows).double().cpu().numpy()


def make_perturbation(problem: dict, coefficients: torch.Tensor, amplitude: float):
    """A smooth divergence-free perturbation (du, dv), float32, on the
    coefficients' device: u = ∂ψ/∂y, v = −∂ψ/∂x of ψ = Σ c_kl sin(kπx/Lx)
    sin(lπy/Ly) over the k, l ≤ K modes of the K×K ``coefficients``,
    scaled so that its largest speed is ``amplitude``."""
    device = coefficients.device
    K = coefficients.shape[0]
    x = torch.linspace(0.0, problem["lx"], problem["nx"], device=device, dtype=torch.float64)
    y = torch.linspace(0.0, problem["ly"], problem["ny"], device=device, dtype=torch.float64)
    k = torch.arange(1, K + 1, device=device, dtype=torch.float64)
    ax = k[:, None] * math.pi / problem["lx"]
    ay = k[:, None] * math.pi / problem["ly"]
    sx, cx = torch.sin(ax * x[None, :]), torch.cos(ax * x[None, :])  # (K, nx)
    sy, cy = torch.sin(ay * y[None, :]), torch.cos(ay * y[None, :])  # (K, ny)
    c = coefficients.to(torch.float64)  # c[l, k]: mode l in y, k in x
    du = (cy * ay).T @ c @ sx          # ∂ψ/∂y
    dv = -(sy.T @ c @ (cx * ax))       # −∂ψ/∂x
    scale = amplitude / torch.sqrt(du * du + dv * dv).amax().clamp(min=1e-30)
    return (du * scale).to(torch.float32), (dv * scale).to(torch.float32)
