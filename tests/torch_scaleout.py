"""Shared cases of the port's scale-out tests (``tests/test_torch_*``).

The same case runs through either package: ``"torch"`` (the port, on the
CPU; over the ranks of a ``parallel._ranks.RankPool`` when given a domain) or
``"jax"`` (the JAX package in the test process, on its virtual CPU
devices). Both packages are imported inside the functions, so a spawned
rank that imports this module loads only the port.
"""

from __future__ import annotations

import importlib

import numpy as np

DAY = 86400


def pkg(name: str):
    return importlib.import_module("parcels_tpu" if name == "jax" else "parcels_tpu_torch")


def _from_sgrid(name, ds, **kw):
    if name == "torch":
        kw["device"] = "cpu"
    return pkg(name).FieldSet.from_sgrid_conventions(ds, **kw)


def uniform(name, u, v, dims=(2, 2, 32, 32)):
    ds = pkg(name).datasets.simple_UV_dataset(dims=dims, mesh="flat")
    ds["U"].values[:] = u
    ds["V"].values[:] = v
    return _from_sgrid(name, ds, mesh="flat")


def cgrid_uniform(name, u=0.3, v=0.5, xdim=32, ydim=32, stretch=1.0, shear=0.0,
                  mesh="flat"):
    """Flat uniform-flow C-grid (LOW padding), as tests/test_domain.py builds
    it; ``stretch`` > 1 spaces the nodes unevenly (node i at (i / n) **
    stretch of the extent), ``shear`` grows U across the rows and V across
    the columns (up to a factor 1 + shear), and a spherical ``mesh`` spans
    0..40 E, 60 S..60 N instead of 2000 km, so that every cell's geometry
    differs."""
    m = pkg(name)
    sgrid = importlib.import_module(m.__name__ + "._sgrid")
    xr = importlib.import_module(m.__name__ + ".xrlite")
    coords = importlib.import_module(m.__name__ + ".datasets.structured")._cgrid_coords
    span_x, span_y, y0 = (2e6, 2e6, 0.0) if mesh == "flat" else (40.0, 120.0, -60.0)
    lon = (span_x * np.linspace(0, 1, xdim) ** stretch).astype(np.float32)
    lat = (y0 + span_y * np.linspace(0, 1, ydim) ** stretch).astype(np.float32)
    grow_y = 1.0 + shear * np.linspace(0, 1, ydim)[:, None]
    grow_x = 1.0 + shear * np.linspace(0, 1, xdim)[None, :]
    ds = xr.Dataset(
        {"U": (["YG", "XC"], (u * grow_y * np.ones((1, xdim))).astype(np.float32)),
         "V": (["YC", "XG"], (v * grow_x * np.ones((ydim, 1))).astype(np.float32))},
        coords=coords(lon, lat, xdim, ydim),
    )
    meta = sgrid.SGrid2DMetadata(
        node_dimensions=("XG", "YG"),
        node_coordinates=("lon", "lat"),
        face_dimensions=(
            sgrid.FaceNodePadding("XC", "XG", sgrid.Padding.LOW),
            sgrid.FaceNodePadding("YC", "YG", sgrid.Padding.LOW),
        ),
    )
    return _from_sgrid(name, sgrid.attach_sgrid_metadata(ds, meta), mesh=mesh)


def fieldset(name, build, **kw):
    """The fieldset of case ``build`` in package ``name``."""
    m = pkg(name)
    window = kw.pop("window", None)
    context = kw.pop("context", {})
    if build == "uniform":
        fs = uniform(name, **kw)
    elif build == "shear":
        fs = shear(name)
    elif build == "rotation":
        fs = _from_sgrid(name, m.datasets.radial_rotation_dataset(), mesh="flat")
    elif build == "curv_rot":
        fs = _from_sgrid(name, m.datasets.curvilinear_rotated_dataset(**kw), mesh="flat")
    elif build == "cgrid_uniform":
        fs = cgrid_uniform(name, **kw)
    elif build == "nemo":
        nemo_style = importlib.import_module(m.__name__ + ".datasets.circulation_models").nemo_style
        fields, coords = nemo_style(**kw)
        fs = _from_sgrid(name, m.convert.nemo_to_sgrid(fields=fields, coords=coords))
    elif build == "moi":
        extra = {"device": "cpu"} if name == "torch" else {}
        fs = m.datasets.moi_like_fieldset(**kw, **extra)
    elif build == "stommel":
        fs = _from_sgrid(name, m.datasets.stommel_gyre_dataset(grid_type="C"), mesh="flat")
    elif build == "mixed":
        fs = mixed(name, **kw)
    elif build == "ux":
        ds = importlib.import_module(m.__name__ + ".datasets.unstructured").delaunay_flow_dataset(
            placement="node", vertical="zf", nx=20, ny=20, extent=1e5, maxdepth=100.0, nz=5,
            **kw)
        extra = {"device": "cpu"} if name == "torch" else {}
        fs = m.FieldSet.from_ugrid_conventions(ds, mesh="flat", **extra)
    else:
        raise ValueError(build)
    for k, v in context.items():
        fs.add_context(k, v)
    if window is not None:
        fs.set_time_window(window)
    return fs


def shear(name, ny=24, nx=24):
    """The solid-body-like shear flow of tests/test_tiles.py."""
    ds = pkg(name).datasets.simple_UV_dataset(dims=(2, 2, ny, nx), mesh="flat")
    yy = np.linspace(-1, 1, ny)[None, None, :, None]
    xx = np.linspace(-1, 1, nx)[None, None, None, :]
    omega = 2 * np.pi / 86400.0
    ds["U"].values[:] = (-yy * omega * 1e6 * np.ones((2, 2, ny, nx))).astype(np.float32)
    ds["V"].values[:] = (xx * omega * 1e6 * np.ones((2, 2, ny, nx))).astype(np.float32)
    return _from_sgrid(name, ds, mesh="flat")


def mixed(name, kind="curv", u_oc=0.15, v_oc=0.08, u_st=-0.05, v_st=0.04):
    """A C-grid or rectilinear ocean UV plus a rectilinear A-grid Stokes UV
    on its own grid, as tests/test_domain_mixed.py builds them."""
    m = pkg(name)
    if kind == "curv":
        nemo_style = importlib.import_module(m.__name__ + ".datasets.circulation_models").nemo_style
        fields, coords = nemo_style(nx=12, ny=32, u=u_oc, v=v_oc)
        fs = _from_sgrid(name, m.convert.nemo_to_sgrid(fields=fields, coords=coords))
        ds2 = m.datasets.simple_UV_dataset(dims=(2, 2, 24, 16), mesh="spherical")
        ds2["U"].values[:] = u_st
        ds2["V"].values[:] = v_st
        fs2 = _from_sgrid(name, ds2, mesh="spherical")
    else:
        fs = uniform(name, 0.0, 5.0, dims=(2, 2, 32, 8))
        fs2 = uniform(name, 3.0, 0.0, dims=(2, 2, 24, 8))
    us = m.Field("Ustokes", np.asarray(fs2.U.data), fs2.U.grid)
    vs = m.Field("Vstokes", np.asarray(fs2.V.data), fs2.V.grid)
    fs.add_field(us)
    fs.add_field(vs)
    velocity = importlib.import_module(m.__name__ + ".interpolators.xinterp").XLinear_Velocity
    fs.add_field(m.VectorField("UVstokes", us, vs, interp_method=velocity()))
    return fs


def _rk4_plus_stokes_torch(particles, fieldset):
    from parcels_tpu_torch.kernels import AdvectionRK4

    AdvectionRK4(particles, fieldset)
    us, vs = fieldset.UVstokes[particles]
    particles.dx = particles.dx + us * particles.dt
    particles.dy = particles.dy + vs * particles.dt


def _rk4_plus_stokes_jax(particles, fieldset):
    from parcels_tpu.kernels import AdvectionRK4

    AdvectionRK4(particles, fieldset)
    us, vs = fieldset.UVstokes[particles]
    particles.dx = particles.dx + us * particles.dt
    particles.dy = particles.dy + vs * particles.dt


def _raise_north_of_zero(particles, fieldset):
    """Raises in the kernel on the ranks that hold a live lane north of y = 0."""
    from parcels_tpu_torch.kernels import AdvectionEE

    if bool(((particles.y > 0) & particles._data["_active"]).any()):
        raise ValueError("a kernel raised on this rank")
    AdvectionEE(particles, fieldset)


def kernel(name, kname):
    if kname == "RK4_PlusStokes":
        return _rk4_plus_stokes_jax if name == "jax" else _rk4_plus_stokes_torch
    if kname == "RaiseNorthOfZero":
        return _raise_north_of_zero
    return getattr(pkg(name).kernels, kname)


def domain(name, fs, spec: dict):
    """The domain or particle mesh of ``spec`` (``kind``: band, tiles,
    mesh); the JAX package's over ``n`` of its devices, the port's over
    the world."""
    par = importlib.import_module(pkg(name).__name__ + ".parallel")
    spec = dict(spec)
    kind, n = spec.pop("kind"), spec.pop("n", 4)
    if kind == "band":
        return par.YBandDomain(fs, n_bands=n, **spec)
    if kind == "tiles":
        return par.XYTileDomain(fs, **spec)
    if name == "jax":
        return par.ParticleMesh(n)
    return par.ParticleMesh(n, devices="cpu")


def run(name, build, x, y, *, env=None, **kw):
    """One release, ``runs`` executes of ``runtime_s`` (with a rebalance
    between them when ``dom`` says so), gathered by particle id; an error
    is returned by name instead of raised. ``env`` sets environment
    variables (engine options) for the run."""
    import os

    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        return _run(name, build, x, y, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _run(name, build, x, y, *, build_kw=None, kernel_name="AdvectionRK4", runtime_s=DAY,
         dt_s=600, dom=None, z=None, rk45=False, output=None, outputdt_s=None, runs=1):
    m = pkg(name)
    fs = fieldset(name, build, **(build_kw or {}))
    kw = {}
    if rk45:
        kw["pclass"] = m.Particle.add_variable(
            m.Variable("next_dt", dtype=np.float64, initial=600.0, to_write=False))
    if z is not None:
        kw["z"] = np.asarray(z).copy()
    pset = m.ParticleSet(fs, x=np.asarray(x).copy(), y=np.asarray(y).copy(),
                         t=np.zeros(len(x)), **kw)
    d, rebalance = None, False
    if dom is not None:
        spec = dict(dom)
        rebalance = spec.pop("rebalance", False)
        balanced = spec.pop("balanced", None)
        if balanced is not None:
            # edges that split this release evenly, from a probe domain
            probe = domain(name, fs, {"kind": "band", "n": spec.get("n", 4),
                                      "halo": spec.get("halo", 2)})
            spec["row_edges"] = probe.balanced_row_edges(np.asarray(y), np.asarray(x),
                                                         **balanced)
        d = domain(name, fs, spec)
        importlib.import_module(m.__name__ + ".parallel").shard_particleset(pset, d)
    out = {}
    pf = None
    if output is not None:
        pf = m.ParticleFile(output, outputdt=np.timedelta64(outputdt_s, "s"), mode="w")
    try:
        for i in range(runs):
            if i and rebalance:
                d.rebalance(np.asarray(pset.y), np.asarray(pset.x))
            if getattr(d, "_row_edges", None) is not None:
                out.setdefault("edges", []).append(np.array(d._row_edges))
            pset.execute(kernel(name, kernel_name), dt=np.timedelta64(dt_s, "s"),
                         runtime=np.timedelta64(runtime_s, "s"), output_file=pf)
    except Exception as e:  # noqa: BLE001 - the case's outcome, returned to the test
        out.update(error=type(e).__name__, message=str(e))
    if pf is not None:
        pf.close()
    if d is not None and hasattr(d, "migration_mode"):
        out["migration_mode"] = d.migration_mode
    order = np.argsort(np.asarray(pset.particle_id))
    for v in ("x", "y", "z", "t", "particle_id", "state"):
        out[v] = np.asarray(getattr(pset, v))[order]
    out["n"] = len(pset)
    if name == "torch":
        out["stats"] = dict(getattr(pset, "last_run_stats", {}) or {})
    return out


_JAX_RUNS: dict = {}


def banded(ranks, timeout=120, **kw):
    """The port's run of a case over the ranks of ``ranks`` (a RankPool);
    every rank must have gathered the same SoA. Returns rank 0's."""
    outs = ranks.run("torch_scaleout", "run", timeout=timeout, name="torch", **kw)
    for o in outs[1:]:
        for v in ("x", "y", "particle_id", "state"):
            np.testing.assert_array_equal(o[v], outs[0][v])
    return outs[0]


def jax_run(key, **kw):
    """The JAX package's run of a case, computed once per test process."""
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = run("jax", **kw)
    return _JAX_RUNS[key]


def assert_same(a, b, **tol):
    """Same particles in the same states, positions within ``tol``."""
    np.testing.assert_array_equal(a["particle_id"], b["particle_id"])
    np.testing.assert_array_equal(a["state"], b["state"])
    for v in ("x", "y"):
        np.testing.assert_allclose(a[v], b[v], **tol)
