"""Dry run of the distributed steps:

    python -m cfdsim_tpu_torch.parallel.dryrun --ranks 4 --device cpu [--topology 2x2]

The explicit half of the JAX package's ``__graft_entry__.dryrun_multichip``
on a grid of 8·max(py, px) cells a side (8 in z): (2) the distributed
red-black SOR solve, (4) the collocated cavity step, (5) the MAC cavity
step with the pencil DCT projection, (5b) the moving body, (6) the 3D MAC
cavity (central, TVD with Smagorinsky LES, dynamic LES), the sphere, the
heated sphere and the stretched sphere (with dynamic LES), (6b2) the
stretched heated sphere, (6b3) the ghost-cell sphere and the stretched
ghost-cell heated sphere, (6c) the moving sphere, the stretched moving
cylinder, their moving ghosts and the stretched moving sphere, (6d) the
heated cavity and the heated cube, (7) the element-sharded FEM monolithic
step and (7b) its projection step on the JAX dry run's ``cylinder_fem``
(re 80, h_far 0.5, h_near 0.12), (8) the pencil-FFT pseudo-spectral step
at ny = max(2n, py·px·max(py, px)); and its GSPMD steps (1) the collocated
cavity with its DCT projection, (3) the 3D cavity with multigrid and (6e)
the MUSCL wedge, with the stable-fluids Kolmogorov step and the 3D blast,
through ``sharded.make_sharded_step`` on ``shard_state`` blocks; each one
call on the mesh, held against the single-device solver or step from the
same input. ``--device cuda``
(the default) runs one NCCL rank per card and needs ``--ranks`` cards;
``--device cpu`` runs gloo ranks on the CPU. Prints one JSON line per check
and exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from cfdsim_tpu_torch.parallel.launch import spawn

# the largest |Δ| a check allows: float32 sums in another order (the 3D
# steps: the JAX tests' 2e-5; their dynamic LES 5e-5, its C_s² a sum over
# the mesh); relative to the largest value, the FEM steps' u (5e-4, the
# Krylov solves stop at their tolerance) and the spectral step's ω (2e-5)
ATOL = 1e-5
ATOL_3D = 2e-5
ATOL_DYNAMIC = 5e-5
RTOL_FEM = 5e-4
RTOL_PS = 2e-5


def _dryrun(mesh):
    from cfdsim_tpu_torch.cases import heated_cavity, lid_cavity, lid_cavity_mac
    from cfdsim_tpu_torch.parallel import (
        block_state,
        gather_blocks,
        gather_state,
        local_block,
        make_cavity_explicit_step,
        make_cavity_mac_explicit_step,
        make_heated_cavity_explicit_step,
        make_sharded_poisson,
        shard_boussinesq_state,
        shard_trimmed_state,
        trim_boussinesq_state,
        trim_state,
    )
    from cfdsim_tpu_torch.solvers.poisson import PoissonConfig, solve_poisson

    n = 8 * max(mesh.py, mesh.px)
    dev = mesh.device
    rows = []

    def diff(name, got, want, **fields):
        rows.append({"check": name, "max_abs_err": float((got - want).abs().max()),
                     "atol": ATOL, **fields})

    # 2) explicit halo-exchange red-black SOR
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal((n, n)).astype(np.float32)
    rhs -= rhs.mean()
    h = 1.0 / n
    solve = make_sharded_poisson(mesh, h, h, iters=4)
    phi = gather_blocks(solve(torch.zeros_like(local_block(rhs, mesh)), local_block(rhs, mesh)),
                        mesh)
    want = solve_poisson(torch.zeros(n, n, device=dev), torch.from_numpy(rhs).to(dev), h, h,
                         PoissonConfig(method="rbsor", iters=4))
    diff("rbsor_solve", phi, want, n=n, sweeps=4)

    # 4) the explicit collocated step
    case = lid_cavity(n=n, Re=100.0, scheme="central",
                      poisson=PoissonConfig(method="rbsor", iters=8), device=dev)
    state, _ = make_cavity_explicit_step(case.cfg, mesh)(block_state(case.state, mesh), 1.0)
    ref, _ = case.step(case.state, 1.0)
    got = gather_state(state, mesh)
    diff("cavity_step", torch.stack([got.u, got.v]), torch.stack([ref.u, ref.v]), n=n)

    # 5) the explicit MAC step with the pencil DCT projection
    case = lid_cavity_mac(n=n, Re=100.0, poisson=PoissonConfig(method="dct"), device=dev)
    state, _ = make_cavity_mac_explicit_step(case.cfg, mesh)(
        shard_trimmed_state(trim_state(case.state), mesh), 1.0)
    ref, _ = case.step(case.state, 1.0)
    got = gather_state(state, mesh)
    diff("mac_cavity_step", torch.stack([got.u, got.v]),
         torch.stack([ref.u[:, :-1], ref.v[:-1, :]]), n=n)

    # 6d) the heated cavity (trimmed faces, θ halos, the pencil DCT)
    case = heated_cavity(n=n, Ra=1e4, device=dev)
    state, _ = make_heated_cavity_explicit_step(case.cfg, mesh)(
        shard_boussinesq_state(trim_boussinesq_state(case.state), mesh), 1.0)
    ref, _ = case.step(case.state, 1.0)
    got = gather_state(state, mesh)
    diff("heated_cavity_step", torch.stack([got.u, got.v, got.theta]),
         torch.stack([ref.u[:, :-1], ref.v[:-1, :], ref.theta]), n=n)
    rows += _dryrun_staggered_3d(mesh, n)
    rows += _dryrun_fem_spectral(mesh, n)
    rows += _dryrun_gspmd_tiers(mesh, n)
    return {"mesh": [mesh.py, mesh.px], "rows": rows}


def _dryrun_gspmd_tiers(mesh, n: int):
    """Steps 1, 3 and 6e, which the JAX dry run runs through GSPMD, and the
    other tiers the JAX package shards only that way, through
    ``make_sharded_step``: one call each against the single-device step,
    relative to the field's largest value."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.parallel.mesh import gather_state
    from cfdsim_tpu_torch.parallel.sharded import make_sharded_step, shard_state

    dev = mesh.device
    rows = []
    for name, check, kw in (
            ("cavity", "gspmd_cavity_step", dict(n=n, Re=100.0)),
            ("cavity3d", "gspmd_cavity3d_step", dict(n=n, Re=100.0)),
            ("wedge", "gspmd_wedge_step", dict(nx=2 * n, ny=n, reconstruction="muscl")),
            ("kolmogorov", "gspmd_kolmogorov_step", dict(ny=n, aspect=2.0)),
            ("blast3d", "gspmd_blast3d_step", dict(n=n))):
        case = build(name, device=dev, **kw)
        got = gather_state(make_sharded_step(case.step, mesh)(shard_state(case.state, mesh),
                                                              1.0)[0], mesh)
        want = case.step(case.state, 1.0)[0]
        err = scale = 0.0
        for f in want._fields:
            a = getattr(want, f)
            if a.ndim >= 2:
                err = max(err, float((getattr(got, f) - a).abs().max()))
                scale = max(scale, float(a.abs().max()))
        rows.append({"check": check, "max_abs_err": err / max(scale, 1.0), "atol": ATOL,
                     "shape": list(case.state[0].shape)})
    return rows


def _dryrun_fem_spectral(mesh, n: int):
    """Steps 7, 7b (the element-sharded FEM steps, elements split over every
    rank) and 8 (the pencil-FFT pseudo-spectral step)."""
    from cfdsim_tpu_torch.cases import build
    from cfdsim_tpu_torch.models import spectral_ps as ps
    from cfdsim_tpu_torch.models.fem import make_projection_step, make_step
    from cfdsim_tpu_torch.parallel import (
        block_state,
        full_spectrum_state,
        gather_state,
        make_fem_explicit_step,
        make_fem_projection_explicit_step,
        make_ps_explicit_step,
    )

    dev = mesh.device
    rows = []

    def rel(name, got, want, rtol, **fields):
        scale = float(want.abs().max())
        rows.append({"check": name, "max_abs_err": float((got - want).abs().max()),
                     "atol": rtol * scale, **fields})

    # 7) and 7b) the FEM steps, replicated DOF vectors, one all-reduce per
    # operator application
    case = build("cylinder_fem", re=80, h_far=0.5, h_near=0.12, viz_shape=(24, 36),
                 gmres_tol=1e-4, device=dev)
    ops, g = case.extras["ops"], case.extras["g"]
    outlet = case.extras["mesh"].tags["outlet"]
    for name, dist_step, ref_step in (
            ("fem_step", make_fem_explicit_step(ops, case.cfg, g, mesh),
             make_step(ops, case.cfg, g)),
            ("fem_projection_step",
             make_fem_projection_explicit_step(ops, case.cfg, g, outlet, mesh),
             make_projection_step(ops, case.cfg, g, outlet))):
        got, _ = dist_step(case.state, 1.0)
        want, _ = ref_step(case.state, 1.0)
        rel(name, got.u, want.u, RTOL_FEM, elements=int(ops.elem_u.shape[0]),
            krylov=dict(dist_step.counts), krylov_single=dict(ref_step.counts))

    # 8) the pseudo-spectral step on the full spectrum
    ps_n = max(2 * n, mesh.py * mesh.px * max(mesh.py, mesh.px))
    cfg = ps.PseudoSpectralConfig(ny=ps_n, aspect=1.0, nu=1e-4, dt=2e-3, forcing_wavenumber=4,
                                  forcing_scale=0.3, linear_friction=0.1)
    state = ps.init_state(cfg, noise=0.1, device=dev)
    got = gather_state(make_ps_explicit_step(cfg, mesh)(
        block_state(full_spectrum_state(cfg, state), mesh), 1.0)[0], mesh)
    want = ps.make_step(cfg, device=dev)(state, 1.0)[0]
    rel("ps_step", torch.fft.ifft2(got.w_hat).real,
        torch.fft.irfft2(want.w_hat, s=(cfg.ny, cfg.nx)), RTOL_PS, n=ps_n)
    return rows


def _dryrun_staggered_3d(mesh, n: int):
    """Steps 5b, 6, 6b2, 6b3, 6c and the 3D half of 6d."""
    from cfdsim_tpu_torch.cases import (
        cylinder_oscillating,
        heated_sphere,
        heated_sphere_stretched,
        sphere_mac3d,
        sphere_stretched,
    )
    from cfdsim_tpu_torch.grid import Grid3D
    from cfdsim_tpu_torch.ibm import oscillating_sphere
    from cfdsim_tpu_torch.models import boussinesq3d as b3
    from cfdsim_tpu_torch.models import mac3d
    from cfdsim_tpu_torch.models import mac_stretched3d as ms3
    from cfdsim_tpu_torch.models.mac_stretched import stretched_faces
    from cfdsim_tpu_torch.parallel import (
        gather_state,
        local_block,
        make_cavity3d_mac_explicit_step,
        make_heated_cube_explicit_step,
        make_heated_sphere_explicit_step,
        make_heated_sphere_stretched_explicit_step,
        make_moving_body3d_stretched_explicit_step,
        make_moving_body_mac3d_explicit_step,
        make_moving_body_mac_explicit_step,
        make_moving_body_stretched_explicit_step,
        make_sphere3d_stretched_explicit_step,
        make_sphere_ghost_mac3d_explicit_step,
        make_sphere_mac3d_explicit_step,
        shard_trimmed_state,
        shard_trimmed_state3d,
        trim_face_masks3d,
        trim_state,
        trim_state3d,
    )

    dev = mesh.device
    rows = []

    def check(name, ref_step, state, step, atol=ATOL_3D, extras=(), **fields):
        """One call of the distributed ``step`` against ``ref_step`` on the
        full state: the trimmed faces (and θ) compared."""
        three_d = state.u.ndim == 3
        trimmed = (trim_state3d if three_d else trim_state)(state)
        blocks = (shard_trimmed_state3d if three_d else shard_trimmed_state)(trimmed, mesh)
        got = gather_state(step(blocks, 1.0, *(local_block(x, mesh) for x in extras))[0], mesh)
        ref = trim_state3d(ref_step(state, 1.0)[0]) if three_d else trim_state(
            ref_step(state, 1.0)[0])
        names = [k for k in ("u", "v", "w", "theta") if hasattr(ref, k)]
        err = max(float((getattr(got, k) - getattr(ref, k)).abs().max()) for k in names)
        rows.append({"check": name, "max_abs_err": err, "atol": atol, "n": n, **fields})

    nz = 8
    box = dict(domain=(4.0, 2.0, 2.0), center=(1.0, 1.0, 1.0), radius=0.25, ibm_ramp_steps=2,
               device=dev)
    stretch = dict(scheme="central", refine_strength=1.0, refine_width=0.5, wake_length=1.0)

    # 5b) the moving body's masks rebuilt on each rank, its force summed
    c = cylinder_oscillating(nx=2 * n, ny=n, domain=(4.0, 2.0), center=(2.0, 1.0), radius=0.25,
                             KC=4.0, period=4.0, device=dev)
    check("moving_body_step", c.step, c.state,
          make_moving_body_mac_explicit_step(c.cfg, mesh, c.extras["body"]), atol=ATOL)

    # 6) the 3D MAC cavity (central; TVD with Smagorinsky; dynamic LES), the
    # sphere, the heated sphere, the stretched sphere (and with dynamic LES)
    cube = Grid3D(nx=n, ny=n, nz=nz, centering="cell")
    for name, kw, atol in (("cavity3d_mac_step", dict(nu=1e-2), ATOL_3D),
                           ("cavity3d_mac_tvd_les_step",
                            dict(nu=2e-3, scheme="tvd", use_les=True), ATOL_3D),
                           ("cavity3d_mac_dynamic_les_step",
                            dict(nu=2e-3, use_les=True, les_model="dynamic"), ATOL_DYNAMIC)):
        cfg = mac3d.MAC3DConfig(grid=cube, max_velocity=5.0, **kw)
        check(name, mac3d.make_step(cfg, mac3d.cavity3d_bcs(), device=dev),
              mac3d.init_state(cfg, device=dev), make_cavity3d_mac_explicit_step(cfg, mesh),
              atol=atol)
    c = sphere_mac3d(nx=2 * n, ny=n, nz=nz, Re=100.0, **box)
    check("sphere_step", c.step, c.state, make_sphere_mac3d_explicit_step(
        c.cfg, mesh, v_inf=1.0, ibm_ramp_steps=2), extras=trim_face_masks3d(*c.extras["ibm_masks"]))
    c = heated_sphere(nx=2 * n, ny=n, nz=nz, Re=100.0, **box)
    mu, mv, mw, mc = c.extras["ibm_masks"]
    check("heated_sphere_step", c.step, c.state, make_heated_sphere_explicit_step(
        c.cfg, mesh, v_inf=1.0, ibm_ramp_steps=2),
        extras=(*trim_face_masks3d(mu, mv, mw), np.asarray(mc, np.float32)))
    for name, kw, atol in (("sphere_stretched_step", dict(Re=100.0), ATOL_3D),
                           ("sphere_stretched_dynamic_les_step",
                            dict(Re=500.0, use_les=True, les_model="dynamic"), ATOL_DYNAMIC)):
        c = sphere_stretched(nx=2 * n, ny=n, nz=nz, **stretch, **kw, **box)
        ex = c.extras
        check(name, c.step, c.state, make_sphere3d_stretched_explicit_step(
            c.cfg, mesh, ex["x_faces"], ex["y_faces"], ex["z_faces"], v_inf=1.0,
            ibm_ramp_steps=2), atol=atol, extras=trim_face_masks3d(*ex["ibm_masks"]))

    # 6b2) the stretched heated sphere; 6b3) the ghost-cell sphere and the
    # stretched ghost-cell heated sphere (this rank's tables, momentum and θ)
    c = heated_sphere_stretched(nx=2 * n, ny=n, nz=nz, Re=100.0, **stretch, **box)
    ex = c.extras
    mu, mv, mw, mc = ex["ibm_masks"]
    check("heated_sphere_stretched_step", c.step, c.state,
          make_heated_sphere_stretched_explicit_step(c.cfg, mesh, ex["x_faces"], ex["y_faces"],
                                                     ex["z_faces"], v_inf=1.0, ibm_ramp_steps=2),
          extras=(*trim_face_masks3d(mu, mv, mw), np.asarray(mc, np.float32)))
    c = sphere_mac3d(nx=2 * n, ny=n, nz=nz, Re=100.0, ibm_scheme="ghost", **box)
    check("sphere_ghost_step", c.step, c.state, make_sphere_ghost_mac3d_explicit_step(
        c.cfg, mesh, c.extras["ibm_ghost"], v_inf=1.0, ibm_ramp_steps=2))
    c = heated_sphere_stretched(nx=2 * n, ny=n, nz=nz, Re=100.0, ibm_scheme="ghost", **stretch,
                                **box)
    ex = c.extras
    check("heated_sphere_stretched_ghost_step", c.step, c.state,
          make_heated_sphere_stretched_explicit_step(
              c.cfg, mesh, ex["x_faces"], ex["y_faces"], ex["z_faces"], v_inf=1.0,
              ibm_ramp_steps=2, ghost=ex["ibm_ghost"], ghost_c=ex["ibm_ghost_c"]))

    # 6c) the moving sphere, the stretched moving cylinder, their moving
    # ghosts, the stretched moving sphere
    # (the moving sphere's box has cubic cells: the moving ghost's window, in
    # lines, grows with the spacing's anisotropy)
    lz = 2.0 * nz / n
    body3 = oscillating_sphere((2.0, 1.0, 0.5 * lz), 0.3, amplitude=0.4, period=4.0)
    cfg3 = mac3d.MAC3DConfig(grid=Grid3D(nx=2 * n, ny=n, nz=nz, x_max=4.0, y_max=2.0, z_max=lz,
                                         centering="cell"), nu=0.01, dt_max=0.02)
    c = cylinder_oscillating(nx=2 * n, ny=n, domain=(4.0, 2.0), center=(2.0, 1.0), radius=0.25,
                             KC=4.0, period=4.0, stretched=True, refine_strength=1.0, device=dev)
    cg = cylinder_oscillating(nx=2 * n, ny=n, domain=(4.0, 2.0), center=(2.0, 1.0),
                              radius=0.25, KC=4.0, period=4.0, stretched=True,
                              refine_strength=1.0, ibm_scheme="ghost", device=dev)
    for scheme in ("penalize", "ghost"):
        tag = "" if scheme == "penalize" else "_ghost"
        check(f"moving_sphere{tag}_step", mac3d.make_step(
            cfg3, mac3d.free_slip_bcs3d(), moving_body=body3, moving_scheme=scheme, device=dev),
            mac3d.init_state(cfg3, device=dev), make_moving_body_mac3d_explicit_step(
                cfg3, mesh, body3, moving_scheme=scheme))
        cc = c if scheme == "penalize" else cg
        check(f"moving_body_stretched{tag}_step", cc.step, cc.state,
              make_moving_body_stretched_explicit_step(cc.cfg, mesh, cc.extras["x_faces"],
                                                       cc.extras["y_faces"], cc.extras["body"],
                                                       moving_scheme=scheme), atol=ATOL)
    xf = stretched_faces(2 * n, 4.0, refine=[(2.0, 0.5, 1.0)])
    yf = stretched_faces(n, 2.0, refine=[(1.0, 0.5, 1.0)])
    zf = stretched_faces(nz, lz, refine=[(0.5 * lz, 0.5, 1.0)])
    cfg_s3 = ms3.StretchedMAC3DConfig(nx=2 * n, ny=n, nz=nz, nu=0.01, scheme="central",
                                      dt_max=0.02)
    check("moving_sphere_stretched_step", ms3.make_step(
        cfg_s3, mac3d.free_slip_bcs3d(), xf, yf, zf, moving_body=body3, device=dev),
        ms3.init_state(cfg_s3, device=dev),
        make_moving_body3d_stretched_explicit_step(cfg_s3, mesh, xf, yf, zf, body3))

    # 6d, 3D half) the heated cube
    cfg = b3.Boussinesq3DConfig(grid=cube, rayleigh=1e4)
    check("heated_cube_step", b3.make_step(cfg, device=dev), b3.init_state(cfg, device=dev),
          make_heated_cube_explicit_step(cfg, mesh))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--topology", default=None, help="PYxPX, e.g. 2x2 (default: most square)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one NCCL rank per card; cpu: gloo ranks")
    args = ap.parse_args(argv)
    topology = None if args.topology is None else tuple(int(k) for k in
                                                       args.topology.lower().split("x"))
    out = spawn(_dryrun, args.ranks, topology, device=args.device)
    ok = True
    for row in out["rows"]:
        row["ok"] = row["max_abs_err"] <= row["atol"]
        ok &= row["ok"]
        print(json.dumps({"mesh": out["mesh"], **row}), flush=True)
    print(json.dumps({"dryrun_ok": ok, "ranks": args.ranks, "mesh": out["mesh"],
                      "device": args.device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
