"""The port's C-grid RK-stage cell cache (ops/stagecache.py) against the
port without it and against parcels_tpu, on MOi-shaped curvilinear grids.

The cache must be semantically invisible: the port with the cache forced
equals the port with it off at the JAX package's own tolerance (rtol 1e-6,
atol 1e-5, tests/test_stagecache.py), and trajectories through the cache
agree with JAX's within 1e-4 deg with identical final states.
``PARCELS_TPU_STAGECACHE`` is set for both packages by monkeypatch.

The stage's prologue and epilogue (``ops/cgrid_stage.py``) are held to the
eager stage they replace on the CPU and, on a card, to their plain versions
bit for bit. The JAX package is imported only inside the test that runs it, so
a card's machine without JAX imports this module and calls the card cases.
"""

import numpy as np
import pytest
import torch

import parcels_tpu_torch as tp
from parcels_tpu_torch.datasets import moi_like_fieldset as t_moi
from parcels_tpu_torch.ops import stagecache

DAY = 86400
CACHE_TOL = dict(rtol=1e-6, atol=1e-5)
REF_ATOL = 1e-4  # deg


def _run(mod, fs, kernel, x, y, z=None, dt_s=1800, runtime_s=DAY, options=None):
    kw = {} if z is None else {"z": z.copy()}
    pset = mod.ParticleSet(fs, x=x.copy(), y=y.copy(), t=np.zeros(x.size), **kw)
    kernel = kernel if callable(kernel) else getattr(mod, kernel)
    pset.execute(kernel, dt=np.timedelta64(dt_s, "s"),
                 runtime=np.timedelta64(runtime_s, "s"), options=options)
    order = np.argsort(pset.particle_id)
    return pset.x[order], pset.y[order], pset.z[order], pset.state[order]


def _seeds(seed, n):
    rng = np.random.default_rng(seed)
    return rng.uniform(-150, 150, n), rng.uniform(-55, 60, n), rng


def _port(mode, monkeypatch, kernel, x, y, z=None, build=None, **kw):
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", mode)
    fs = (build or (lambda: t_moi(xdim=96, ydim=64, zdim=3, seed=2, device="cpu")))()
    return _run(tp, fs, kernel, x, y, z, **kw)


@pytest.mark.parametrize("dt_s", [1800, 21600])  # small dt: hits; 6 h: cell-crossing misses
def test_stagecache_matches_plain_2d(monkeypatch, dt_s):
    x, y, _ = _seeds(0, 512)
    runtime_s = DAY if dt_s == 21600 else DAY // 2
    ref = _port("off", monkeypatch, "AdvectionRK4", x, y, dt_s=dt_s, runtime_s=runtime_s)
    checked = stagecache.cgrid_cached_eval.checked_lanes
    got = _port("force", monkeypatch, "AdvectionRK4", x, y, dt_s=dt_s, runtime_s=runtime_s)
    assert stagecache.cgrid_cached_eval.checked_lanes > checked, "the stage cache did not run"
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g, r, **CACHE_TOL)
    np.testing.assert_array_equal(got[3], ref[3])
    if dt_s == 21600:
        # JAX through its own stage cache, on the same inputs
        import parcels_tpu as jp
        from parcels_tpu.datasets import moi_like_fieldset as j_moi

        monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
        jref = _run(jp, j_moi(xdim=96, ydim=64, zdim=3, seed=2), "AdvectionRK4", x, y,
                    dt_s=dt_s, runtime_s=runtime_s)
        for g, r in zip(got[:3], jref[:3]):
            np.testing.assert_allclose(g, r, rtol=0, atol=REF_ATOL)
        np.testing.assert_array_equal(got[3], jref[3])


def test_stagecache_matches_plain_3d(monkeypatch):
    x, y, rng = _seeds(1, 256)
    z = rng.uniform(5.0, 800.0, 256)

    def build():
        return t_moi(xdim=96, ydim=64, zdim=6, seed=3, with_w=True, device="cpu")

    ref = _port("off", monkeypatch, "AdvectionRK4_3D", x, y, z, build=build)
    got = _port("force", monkeypatch, "AdvectionRK4_3D", x, y, z, build=build)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g, r, **CACHE_TOL)
    np.testing.assert_array_equal(got[3], ref[3])


def test_stagecache_closed_form_uniform_flow(monkeypatch):
    u = 0.25
    x, y, _ = _seeds(2, 64)
    y = np.clip(y, -50, 40)
    xs, ys, _, _ = _port("force", monkeypatch, "AdvectionRK4", x, y,
                         build=lambda: t_moi(xdim=96, ydim=64, zdim=3, u=u, v=0.0, device="cpu"))
    deg2m = tp.EARTH_RADIUS * np.pi / 180.0
    np.testing.assert_allclose(xs, x + u * DAY / (deg2m * np.cos(np.deg2rad(y))), atol=2e-3)
    np.testing.assert_allclose(ys, y, atol=2e-3)


def _add_stokes(fs, uscale=-0.5, vscale=0.25):
    """A second curvilinear C-grid vector field on the same grid."""
    from parcels_tpu_torch._core.field import Field, VectorField

    us = Field("Ustokes", np.asarray(fs.U.data) * uscale, fs.U.grid)
    vs = Field("Vstokes", np.asarray(fs.V.data) * vscale, fs.V.grid)
    fs.add_field(us)
    fs.add_field(vs)
    fs.add_field(VectorField("UVstokes", us, vs, interp_method=tp.CGrid_Velocity()))
    return fs


def AdvectionEE_TwoFields(particles, fieldset):
    u1, v1 = fieldset.UV[particles]
    u2, v2 = fieldset.UVstokes[particles]
    particles.dx = particles.dx + (u1 + u2) * particles.dt
    particles.dy = particles.dy + (v1 + v2) * particles.dt


def test_stagecache_two_vector_fields_no_crosstalk(monkeypatch):
    """Two C-grid vector fields on one grid never blend each other's cached
    face values: only the owner (the first) persists into the SoA."""
    x, y, _ = _seeds(7, 256)

    def build():
        return _add_stokes(t_moi(xdim=96, ydim=64, zdim=3, seed=2, device="cpu"))

    assert stagecache.soa_cache_owner(build())[0] is None  # auto on the CPU: no persistence
    ref = _port("off", monkeypatch, AdvectionEE_TwoFields, x, y, build=build, runtime_s=6 * 3600)
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    assert stagecache.soa_cache_owner(build()) == ("UV", False)
    got = _port("force", monkeypatch, AdvectionEE_TwoFields, x, y, build=build,
                runtime_s=6 * 3600)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g, r, **CACHE_TOL)


def test_stagecache_oob_error_preserved(monkeypatch):
    """A particle leaving the grid raises the same typed error with the cache
    forced as without it."""

    def run(mode):
        monkeypatch.setenv("PARCELS_TPU_STAGECACHE", mode)
        fs = t_moi(xdim=96, ydim=64, zdim=3, u=0.0, v=20.0, device="cpu")
        pset = tp.ParticleSet(fs, x=[0.0], y=[78.0], t=[0.0])
        # a spherical grid has no outside: the lane fails the search
        with pytest.raises((tp.FieldOutOfBoundError, tp.GridSearchingError)) as e:
            pset.execute(tp.AdvectionRK4, dt=np.timedelta64(1, "h"),
                         runtime=np.timedelta64(1, "D"))
        return type(e.value)

    assert run("force") is run("off")


def test_engine_options_force_and_cache_columns(monkeypatch, tmp_path):
    """EngineOptions(stagecache="force") runs the cache through execute; its
    SoA columns are injected (invalid on padded lanes) but are neither
    particle variables nor ParticleFile output."""
    monkeypatch.delenv("PARCELS_TPU_STAGECACHE", raising=False)
    x, y, _ = _seeds(3, 5)
    fs = t_moi(xdim=96, ydim=64, zdim=3, seed=2, device="cpu")
    files = {}
    for mode in ("off", "force"):
        pset = tp.ParticleSet(fs, x=x, y=y, t=np.zeros(5))
        pf = tp.ParticleFile(tmp_path / f"{mode}.parquet", outputdt=np.timedelta64(3600, "s"))
        pset.execute(tp.AdvectionRK4, dt=np.timedelta64(1800, "s"),
                     runtime=np.timedelta64(7200, "s"), output_file=pf,
                     options=tp.EngineOptions(stagecache=mode))
        pf.close()
        files[mode] = tp.read_particlefile(tmp_path / f"{mode}.parquet")
        if mode == "force":
            key = pset._data["_sc_key"]
            assert key.shape == (8, 4) and (key[:5, 0] >= 0).all()
            with pytest.raises(AttributeError):
                pset._sc_key  # noqa: B018
            inv = stagecache.invalidate_soa_cache(pset._data)
            assert (inv["_sc_key"][:, 0] == -1).all() and (key[:5, 0] >= 0).all()
            assert torch.equal(inv["_sc_key"][:, 1:], key[:, 1:])
            # padding gives the columns invalid keys
            fresh = tp.ParticleSet(fs, x=x, y=y, t=np.zeros(5))
            fresh._data.update(stagecache.make_soa_cache(5, False, "cpu"))
            fresh._data["_sc_key"][:, 0] = 3
            fresh._pad_capacity(8)
            assert (fresh._data["_sc_key"][5:] == -1).all()
            assert (fresh._data["_sc_u4"][5:] == 0).all()
    assert list(files["force"].columns) == list(files["off"].columns)
    assert not any(c.startswith("_sc_") for c in files["force"].columns)
    np.testing.assert_allclose(files["force"]["x"].to_numpy(), files["off"]["x"].to_numpy(),
                               **CACHE_TOL)


@pytest.mark.parametrize("last_lane_misses", [True, False])
def test_miss_repair_rounds_and_last_lane(monkeypatch, last_lane_misses):
    """A cached eval after lanes moved to other cells equals a fresh full
    eval bit for bit, over two repair rounds whose last is padded with lane
    n - 1 (itself a miss or not)."""
    from parcels_tpu_torch._core.particles_view import Particles

    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    fs = t_moi(xdim=96, ydim=64, zdim=3, seed=2, device="cpu")
    n = 2048
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.uniform(-150, 150, n), dtype=torch.float32)
    y = torch.as_tensor(rng.uniform(-55, 60, n), dtype=torch.float32)
    moved = torch.zeros(n, dtype=torch.bool)
    moved[::2] = True  # 1025 misses: two rounds of K = 1024
    moved[-1] = last_lane_misses
    moved[1] = not last_lane_misses
    x2 = torch.where(moved, x + 7.5, x)  # two cells east
    t = torch.full((n,), 3600.0)
    z = torch.full((n,), 1.0)

    def pdata():
        return {"state": torch.zeros(n, dtype=torch.int32),
                "ei": torch.zeros((n, 1), dtype=torch.int32),
                "_active": torch.ones(n, dtype=torch.bool)}

    vf = fs.build_views(fs.device_arrays()).UV
    pd = pdata()
    vf.eval(t, z, y, x, Particles(pd, pd["_active"]))
    rounds = stagecache.cgrid_cached_eval.miss_rounds
    u, v = vf.eval(t, z, y, x2, Particles(pd, pd["_active"]))
    assert stagecache.cgrid_cached_eval.miss_rounds - rounds == 2
    vf2 = fs.build_views(fs.device_arrays()).UV
    pd2 = pdata()
    u2, v2 = vf2.eval(t, z, y, x2, Particles(pd2, pd2["_active"]))
    assert torch.equal(u, u2) and torch.equal(v, v2)
    assert torch.equal(pd["ei"], pd2["ei"]) and torch.equal(pd["state"], pd2["state"])
    for k in ("cell", "u4", "v4", "row"):
        assert torch.equal(vf._stage_cache[k], vf2._stage_cache[k]), k


# ---------------------------------------------------------------------------
# the stage's prologue and epilogue (ops/cgrid_stage.py): the plain versions
# on the CPU against the eager composition they replace, and on a card the
# kernels against the plain versions, bit for bit
# ---------------------------------------------------------------------------

DEVICES = ["cpu", "cuda"]
DEPTHS = ["uniform", "nemo50", "long200", "one", "none"]
TIMES = ["static", "two", "three_uniform", "three_stretched"]


def _need_card(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _same_bits(a, b):
    """Equal bit for bit; NaN lanes NaN in both (their payloads not compared)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    same = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    return bool(same.all())


def _axis_view(depth, time, device, has_w, spherical):
    """A stand-in vector-field view with the given depth and time axes: what
    the prologue reads of a view (spec, axes, the U and W shapes)."""
    from types import SimpleNamespace

    from parcels_tpu_torch._core.grid import _uniform_spacing
    from parcels_tpu_torch.datasets.moi import _stretched_depth

    nodes = {"uniform": np.arange(6) * 10.0, "nemo50": _stretched_depth(50),
             "long200": _stretched_depth(200), "one": np.array([5.0]), "none": np.zeros(1)}[depth]
    frames = {"static": np.zeros(1), "two": np.array([0.0, 86400.0]),
              "three_uniform": np.array([0.0, 86400.0, 172800.0]),
              "three_stretched": np.array([0.0, 3600.0, 86400.0])}[time]
    spec = SimpleNamespace(
        axes=("Y", "X") if depth == "none" else ("Z", "Y", "X"), spherical=spherical,
        depth_uniform=_uniform_spacing(nodes), time_uniform=_uniform_spacing(frames),
        offset_z=1 if has_w else 0)
    garrs = {"depth": torch.as_tensor(nodes.astype(np.float32), device=device),
             "time": torch.as_tensor(frames.astype(np.float32), device=device)}

    def field(levels):
        return SimpleNamespace(data=SimpleNamespace(shape=(frames.size, levels, 4, 4)),
                               has_time=frames.size > 1)

    Z = nodes.size if depth != "none" else 1
    return SimpleNamespace(grid=SimpleNamespace(spec=spec, garrs=garrs), U=field(Z),
                           W=field(Z) if has_w else None), nodes, frames


def _prologue_lanes(nodes, frames, device, n=4096, seed=5):
    """t, z, y, x: random lanes with every node and frame exactly, lanes
    below the first and above the last, t outside the interval, and NaN in
    each of t, z, y and x."""
    rng = np.random.default_rng(seed)
    zmax, tmax = max(nodes[-1], 1.0), max(frames[-1], 3600.0)
    z = rng.uniform(-0.1 * zmax, 1.1 * zmax, n)
    t = rng.uniform(-0.2 * tmax, 1.2 * tmax, n)
    z[:nodes.size] = nodes
    t[:frames.size] = frames
    z[nodes.size:nodes.size + 3] = [nodes[0] - 1.0, nodes[-1] + 1.0, -0.0]
    t[frames.size:frames.size + 2] = [frames[0] - 60.0, frames[-1] + 60.0]
    y, x = rng.uniform(-80, 80, n), rng.uniform(-180, 180, n)
    for v, k in ((t, 97), (z, 89), (y, 83), (x, 79)):
        v[256 + k::211] = np.nan
    return tuple(torch.as_tensor(v.astype(np.float32), device=device) for v in (t, z, y, x))


def _eager_prologue(vf, t, z, y, x):
    """The eager brackets, escalation codes and query coordinates the
    prologue replaces, composed from stage_brackets and query_xyz."""
    from parcels_tpu_torch._core import index_search
    from parcels_tpu_torch._core.statuscodes import StatusCode

    ti, t1i, tau, t_oob, zi_raw, zc, zeta, wzi, _ = stagecache.stage_brackets(vf, t, z)
    esc_zt = torch.maximum(
        torch.where(zi_raw == index_search.RIGHT_OUT_OF_BOUNDS, int(StatusCode.ErrorOutOfBounds), 0),
        torch.where(zi_raw == index_search.LEFT_OUT_OF_BOUNDS, int(StatusCode.ErrorThroughSurface), 0),
    )
    if t_oob is not None:
        esc_zt = torch.maximum(esc_zt, torch.where(t_oob, int(StatusCode.ErrorOutsideTimeInterval), 0))
    q = index_search.query_xyz(y, x, vf.grid.spec.spherical)
    return (ti, t1i, tau, zi_raw, zc, zeta, wzi, esc_zt.to(torch.int32), zi_raw < 0, q)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("time", TIMES)
@pytest.mark.parametrize("depth", DEPTHS)
def test_stage_prologue_brackets(depth, time, device):
    """The prologue's brackets, codes and query coordinates: on the CPU its
    plain version against the eager ops it replaces, on a card the kernel
    against the plain version, bit for bit; uniform and stretched axes, an
    axis longer than 128 nodes, one level, one to three frames, lanes on
    the nodes, outside them and NaN in each of t, z, y, x."""
    from parcels_tpu_torch.ops import cgrid_stage

    _need_card(device)
    case = DEPTHS.index(depth) + len(DEPTHS) * TIMES.index(time)
    vf, nodes, frames = _axis_view(depth, time, device, has_w=case % 2 == 0,
                                   spherical=case % 3 != 0)
    lanes = _prologue_lanes(nodes, frames, device)
    launches = cgrid_stage.stage_prologue.launches
    got = cgrid_stage.stage_prologue(vf, *lanes)
    want = (_eager_prologue(vf, *lanes) if device == "cpu"
            else cgrid_stage.stage_prologue_plain(vf, *lanes))
    assert cgrid_stage.stage_prologue.launches - launches == (device == "cuda")
    for name, g, w in zip(cgrid_stage.Brackets._fields, got, want):
        for k, (gk, wk) in enumerate(zip(g, w) if name == "q" else [(g, w)]):
            assert _same_bits(gk, wk), (name, k)
    zi_raw = got.zi_raw.cpu().numpy()
    if depth in ("uniform", "nemo50", "long200"):
        # the nodes bracket their own cells, outside lanes take the sentinels
        np.testing.assert_array_equal(zi_raw[:nodes.size - 1], np.arange(nodes.size - 1))
        assert list(zi_raw[nodes.size:nodes.size + 2]) == [-2, -1]


def _stage_fixture(grid, device):
    """A fieldset of the existing fixtures and its C-grid view name: the
    MOi-like spherical grid, 2-D or with W, and the rotated flat grid."""
    if grid == "rotated":
        from parcels_tpu_torch._core.field import VectorField
        from parcels_tpu_torch.datasets import curvilinear_rotated_dataset

        fs = tp.FieldSet.from_sgrid_conventions(curvilinear_rotated_dataset(xdim=50, ydim=40),
                                                mesh="flat", device=device)
        fs.add_field(VectorField("UVc", fs.U, fs.V, interp_method=tp.CGrid_Velocity()))
        return fs, "UVc"
    fs = t_moi(xdim=96, ydim=64, zdim=6 if grid == "moi3d" else 3, seed=3,
               with_w=grid == "moi3d", device=device)
    return fs, "UVW" if grid == "moi3d" else "UV"


def _stage_lanes(fs, grid, device, n=4096, seed=9):
    """A first eval's lanes and the next stage's (a third of them moved a
    cell or two), with masked, NaN, infinite and out-of-bounds lanes."""
    rng = np.random.default_rng(seed)
    if grid == "rotated":
        g = fs.gridset[0]
        x = rng.uniform(g.lon.min(), g.lon.max(), n)
        y = rng.uniform(g.lat.min(), g.lat.max(), n)
        step = 1500.0
    else:
        x, y = rng.uniform(-170, 170, n), rng.uniform(-60, 70, n)
        step = 5.0
    z = rng.uniform(1.0, 900.0, n) if grid == "moi3d" else np.full(n, 1.0)
    z[::101] = -5.0  # through the surface
    z[1::103] = 9000.0  # below the deepest level
    t = rng.uniform(0.0, 86400.0, n)
    t[::107] = 2e5  # outside the time interval
    moved = rng.random(n) < 0.33
    x2 = np.where(moved, x + rng.choice([-1.0, 1.0], n) * rng.uniform(0.3, 1.2, n) * step, x)
    y2 = np.where(moved, y + rng.choice([-1.0, 1.0], n) * rng.uniform(0.3, 1.2, n) * step, y)
    y2[::97] = np.nan
    x2[::89] = np.inf
    mask = rng.random(n) < 0.85
    T = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float32), device=device)  # noqa: E731
    return (T(t), T(z), T(y), T(x)), (T(t + 300.0), T(z), T(y2), T(x2)), torch.as_tensor(
        mask, device=device)


def _eager_eval(vf, t, z, y, x, particles):
    """The stage as eager ops around K5, as cgrid_cached_eval ran it before
    its prologue and epilogue kernels."""
    from parcels_tpu_torch._core.field import _escalate
    from parcels_tpu_torch._core.statuscodes import StatusCode
    from parcels_tpu_torch.ops import cgrid_repair

    spec = vf.grid.spec
    ti, t1i, tau, zi_raw, zc, zeta, wzi, esc_zt, z_oob, q = _eager_prologue(vf, t, z, y, x)
    Zw = vf.W.data.shape[1] if vf.W is not None else 1
    c = vf._stage_cache
    if c is None:
        cx = max(spec.xdim, 1)
        ei = particles._get_ei(vf.igrid)
        c = cgrid_repair.cgrid_full(vf, y, x, q, ti, t1i, zc, wzi,
                                    torch.div(ei, cx, rounding_mode="floor") % max(spec.ydim, 1),
                                    ei % cx)
        xsi, eta = c.pop("xsi"), c.pop("eta")
        c.update(ti=ti, zi=zc, wzi=wzi)
    else:
        c = dict(c)
        n = y.shape[0]
        st = cgrid_repair.cgrid_stage(vf, c, y, x, q, ti, t1i, zc, wzi, particles._mask,
                                      min(n, max(1024, n // stagecache.K_DIV)))
        xsi, eta = st.xsi, st.eta
    vf._stage_cache = c
    u, v, w = stagecache._blend(spec, c["row"], xsi, eta, tau, zeta, c["u4"], c["v4"], c["w4"],
                                Zw, y)
    particles.state = torch.maximum(particles.state, torch.maximum(esc_zt, c["esc"]))
    _escalate(particles, torch.isnan(u) | torch.isnan(v) | torch.isnan(w),
              StatusCode.ErrorInterpolation)
    particles._set_ei(vf.igrid, (zc * max(spec.ydim, 1) + c["yi"]) * max(spec.xdim, 1) + c["xi"])
    mask0 = c["oob"] | z_oob
    out = tuple(torch.where(mask0, 0.0, a) for a in (u, v, w))
    return out if vf.vector_type == "3D" else out[:2]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("grid", ["moi2d", "moi3d", "rotated"])
def test_cgrid_cached_eval_equals_the_eager_stage(monkeypatch, grid, device):
    """``cgrid_cached_eval`` (prologue, K5, epilogue) against the eager
    stage on the same lanes, a first full eval and then a steady stage:
    velocities, particle state, ``ei`` and the cache columns bit for bit,
    with masked, NaN, infinite, through-surface, too deep and out-of-time
    lanes; 2-D and 3-D (W), spherical and flat. On a card each wrapper
    launches once a stage."""
    from parcels_tpu_torch._core.particles_view import Particles
    from parcels_tpu_torch.ops import cgrid_stage

    _need_card(device)
    monkeypatch.setenv("PARCELS_TPU_STAGECACHE", "force")
    fs, name = _stage_fixture(grid, device)
    first, second, mask = _stage_lanes(fs, grid, device)
    n = mask.shape[0]
    views = [getattr(fs.build_views(fs.device_arrays()), name) for _ in range(2)]
    assert stagecache.enabled(views[0])
    pds = [{"state": torch.zeros(n, dtype=torch.int32, device=device),
            "ei": torch.zeros((n, len(fs.gridset)), dtype=torch.int32, device=device)}
           for _ in range(2)]
    for lanes in (first, second):
        before = (cgrid_stage.stage_prologue.launches, cgrid_stage.stage_epilogue.launches)
        got = stagecache.cgrid_cached_eval(views[0], *lanes, Particles(pds[0], mask))
        after = (cgrid_stage.stage_prologue.launches, cgrid_stage.stage_epilogue.launches)
        assert [b - a for a, b in zip(before, after)] == [int(device == "cuda")] * 2
        want = _eager_eval(views[1], *lanes, Particles(pds[1], mask))
        assert len(got) == len(want) == (3 if grid == "moi3d" else 2)
        for k, (g, w) in enumerate(zip(got, want)):
            assert _same_bits(g, w), "uvw"[k]
        for key in ("state", "ei"):
            assert _same_bits(pds[0][key], pds[1][key]), key
        c0, c1 = views[0]._stage_cache, views[1]._stage_cache
        assert sorted(c0) == sorted(c1)
        for key, v in c1.items():
            assert (v is None and c0[key] is None) or _same_bits(c0[key], v), key
    states = pds[0]["state"].cpu().numpy()
    # the fixture reaches the escalations of its axes (the rotated grid has
    # no depth or time axis)
    codes = {tp.StatusCode.ErrorOutOfBounds}
    if grid != "rotated":
        codes |= {tp.StatusCode.ErrorOutsideTimeInterval, tp.StatusCode.ErrorThroughSurface}
    assert {int(c) for c in codes} <= set(states.tolist())
    assert (states[~mask.cpu().numpy()] == 0).all()
